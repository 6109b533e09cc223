"""The port's checkpoint loading (``youtube_vln_tpu_torch/training/
checkpoint.py``) against the JAX package's (``youtube_vln_tpu/training/
checkpoint.py``): a file written by JAX ``save_checkpoint`` loads into the
tensors that ``state_dict_from_jax_params`` makes of the same parameters
(exactly), and both packages report the same missing and unexpected lists,
step and epoch, for a ``.bin``, a directory and a ``.tar.gz``; a checkpoint
without the task heads leaves them at their initialisation; a URL raises."""
import tarfile

import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.models import torch_io
from youtube_vln_tpu.models import torch_serialization as tser
from youtube_vln_tpu.training import checkpoint as jckpt
from youtube_vln_tpu_torch.config import tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
from youtube_vln_tpu_torch.training import checkpoint as pckpt

HEADS = dict(ranking=True, traj_judge=True, masked_vision=True,
             masked_language=True)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny_config(**HEADS)
    params = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(3), cfg))
    return cfg, params, tiny_config(**HEADS)


def _jax_report(path, cfg, seed=11):
    """(missing, unexpected, step, epoch, params) as JAX load_checkpoint
    sees them: the lists come from state_dict_to_params, filtered as its
    log line filters them (checkpoint.py:162-167)."""
    fresh = jax.tree_util.tree_map(
        np.asarray, init_lily_params(jax.random.PRNGKey(seed), cfg))
    weights, tempdir = jckpt.resolve_pretrained(path)
    try:
        payload = tser.load(weights)
    finally:
        if tempdir:
            import shutil
            shutil.rmtree(tempdir, ignore_errors=True)
    _, missing, unexpected = torch_io.state_dict_to_params(
        payload, cfg, jax.tree_util.tree_map(np.copy, fresh))
    unexpected = [k for k in unexpected if "q_dense" not in k and k not in (
        "epoch", "jax_step", "jax_optimizer_state", "optimizer_state_dict",
        "scheduler_state_dict")]
    loaded, _, step, epoch = jckpt.load_checkpoint(path, cfg, fresh)
    return missing, unexpected, step, epoch, loaded


def _assert_model_holds(model, params, port_cfg):
    want = state_dict_from_jax_params(params, port_cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("form", ["bin", "dir", "targz"])
def test_jax_checkpoint_loads_into_equal_tensors(tmp_path, setup, form):
    cfg, params, port_cfg = setup
    path = jckpt.save_checkpoint(str(tmp_path), "ckpt", params, cfg,
                                 opt_state={"m": np.ones(3, np.float32)},
                                 step=17, epoch=4)
    if form == "dir":
        (tmp_path / "d").mkdir()
        (tmp_path / "ckpt.bin").rename(tmp_path / "d" / "pytorch_model.bin")
        path = str(tmp_path / "d")
    elif form == "targz":
        path = str(tmp_path / "ckpt.tar.gz")
        with tarfile.open(path, "w:gz") as tar:
            tar.add(tmp_path / "ckpt.bin", arcname="pytorch_model.bin")
    model = Lily(port_cfg, device="cpu").init_weights(5)
    got = pckpt.load_checkpoint(path, model)
    missing, unexpected, step, epoch, loaded = _jax_report(path, cfg)
    assert got == (missing, unexpected, step, epoch) == ([], [], 17, 4)
    _assert_model_holds(model, params, port_cfg)
    _assert_model_holds(model, loaded, port_cfg)
    # the tied decoder still shares the word embedding
    assert (model.cls.predictions.decoder.weight.data_ptr()
            == model.bert.embeddings.word_embeddings.weight.data_ptr())


@pytest.mark.parametrize("prefixed", [True, False], ids=["bert", "no_prefix"])
def test_pretraining_checkpoint_keeps_the_heads_initialised(tmp_path, setup,
                                                           prefixed):
    """A BertModel dump (no task heads, gamma/beta names, with or without
    the ``bert.`` prefix, plus an entry no tensor takes) into a fine-tuning
    model: the encoder loads, every head keeps its initialisation, and both
    packages report the same lists."""
    cfg, params, port_cfg = setup
    sd = torch_io.params_to_state_dict(params, cfg)
    dump = {}
    for k, v in sd.items():
        if not k.startswith("bert."):
            continue
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
            "LayerNorm.bias", "LayerNorm.beta")
        dump[k if prefixed else k[len("bert."):]] = v
    dump["bert.extra_buffer" if prefixed else "extra_buffer"] = np.zeros(2, np.float32)
    path = str(tmp_path / "pretrained.bin")
    tser.save(dump, path)

    model = Lily(port_cfg, device="cpu").init_weights(5)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = pckpt.load_checkpoint(path, model)
    missing, unexpected, step, epoch, _ = _jax_report(path, cfg)
    assert got == (missing, unexpected, step, epoch)
    assert unexpected == ["bert.extra_buffer"] and step == 0 and epoch == -1
    assert "vil_logit.weight" in missing and "cls.predictions.bias" in missing
    want = state_dict_from_jax_params(params, port_cfg)
    for k, v in model.state_dict().items():
        if k.startswith("bert."):
            assert torch.equal(v, want[k]), k
        elif k != "cls.predictions.decoder.weight":
            assert torch.equal(v, init[k]), k


def test_missing_tensor_keeps_its_initialisation(tmp_path, setup):
    """The per-tensor rule: a linear with only its weight in the file loads
    the weight and reports the bias missing."""
    cfg, params, port_cfg = setup
    sd = torch_io.params_to_state_dict(params, cfg)
    del sd["vil_logit.bias"], sd["bert.t_pooler.dense.weight"]
    path = str(tmp_path / "partial.bin")
    tser.save({"model_state_dict": sd, "epoch": 2}, path)
    model = Lily(port_cfg, device="cpu").init_weights(5)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = pckpt.load_checkpoint(path, model)
    assert got == _jax_report(path, cfg)[:4]
    assert got[0] == ["bert.t_pooler.dense.weight", "vil_logit.bias"]
    state = model.state_dict()
    for k in ("vil_logit.bias", "bert.t_pooler.dense.weight"):
        assert torch.equal(state[k], init[k])
    assert torch.equal(state["vil_logit.weight"],
                       torch.tensor(np.array(sd["vil_logit.weight"])))


def test_url_and_missing_paths_raise(tmp_path, setup, monkeypatch):
    """A URL resolves through the offline file cache alone: one that is not
    cached raises, naming where to place it; missing and unreadable paths
    raise too."""
    from youtube_vln_tpu_torch.utils import file_cache
    monkeypatch.setattr(file_cache, "CACHE_DIR", tmp_path / "cache")
    model = Lily(setup[2], device="cpu")
    with pytest.raises(FileNotFoundError, match="not cached"):
        pckpt.load_checkpoint("https://example.invalid/model.bin", model)
    with pytest.raises(FileNotFoundError):
        pckpt.load_checkpoint(str(tmp_path / "absent.tar.gz"), model)
    bad = tmp_path / "notes.txt"
    bad.write_text("not an archive")
    with pytest.raises(ValueError, match="not a recognized checkpoint"):
        pckpt.load_checkpoint(str(bad), model)


def test_checkpoint_paths_and_delete(tmp_path):
    assert pckpt.checkpoint_path("a/b", "best") == jckpt.checkpoint_path("a/b", "best")
    path = tmp_path / "3.bin"
    path.write_bytes(b"x")
    pckpt.delete_checkpoint(str(tmp_path), "3")
    assert not path.exists()
    pckpt.delete_checkpoint(str(tmp_path), "3")   # absent: no error


def _trained(port_cfg, seed, steps=2):
    """A model and an AdamWRef that took ``steps`` steps on made-up
    gradients: moments and step_count that differ from a fresh optimizer."""
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.parallel.train_step import create_train_state
    model = Lily(port_cfg, device="cpu").init_weights(seed)
    optimizer, _ = create_train_state(model, RunConfig(ranking=True), 10)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        optimizer.step()
    return model, optimizer


def test_save_load_round_trip(tmp_path, setup):
    """Weights bit-equal, moments and step_count restored, the tied decoder
    still shared, no .tmp left; without an optimizer the load leaves one
    fresh."""
    _, _, port_cfg = setup
    model, optimizer = _trained(port_cfg, 1, steps=3)
    path = pckpt.save_checkpoint(str(tmp_path), "run", model, port_cfg,
                                 optimizer=optimizer, step=3, epoch=2)
    assert path == pckpt.checkpoint_path(str(tmp_path), "run")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run.bin"]

    fresh, fresh_opt = _trained(port_cfg, 9, steps=0)
    got = pckpt.load_checkpoint(path, fresh, optimizer=fresh_opt)
    assert got == ([], [], 3, 2)
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    assert (fresh.cls.predictions.decoder.weight.data_ptr()
            == fresh.bert.embeddings.word_embeddings.weight.data_ptr())
    assert fresh_opt.step_count == 3
    for p, q in zip(model.parameters(), fresh.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(optimizer.state[p][k], fresh_opt.state[q][k])
    # the next step of both is the same step
    for p, q in zip(model.parameters(), fresh.parameters()):
        p.grad = q.grad = torch.ones_like(p)
    optimizer.step()
    fresh_opt.step()
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)

    untouched, untouched_opt = _trained(port_cfg, 9, steps=0)
    pckpt.load_checkpoint(path, untouched)
    assert untouched_opt.step_count == 0 and not untouched_opt.state


def test_saved_keys_equal_the_jax_save(tmp_path, setup):
    """The model_state_dict key set and shapes of the JAX save_checkpoint
    of the same config; the payload's other entries are the step, the
    epoch and the optimizer state, which torch.load(weights_only=True)
    reads."""
    cfg, params, port_cfg = setup
    model, optimizer = _trained(port_cfg, 2)
    pckpt.save_checkpoint(str(tmp_path), "port", model, port_cfg,
                          optimizer=optimizer, step=2, epoch=0)
    jckpt.save_checkpoint(str(tmp_path), "jax", params, cfg, step=2, epoch=0)
    port = torch.load(tmp_path / "port.bin", map_location="cpu",
                      weights_only=True)
    jax_payload = tser.load(str(tmp_path / "jax.bin"))
    assert set(port) == {"model_state_dict", "epoch", "jax_step",
                         "optimizer_state_dict"}
    psd, jsd = port["model_state_dict"], jax_payload["model_state_dict"]
    assert set(psd) == set(jsd)
    for k in jsd:
        assert tuple(psd[k].shape) == jsd[k].shape and psd[k].dtype == torch.float32, k
        if "q_dense" in k:
            assert not psd[k].any(), k
    assert psd["cls.predictions.decoder.weight"].data_ptr() == \
        psd["bert.embeddings.word_embeddings.weight"].data_ptr()
    opt = port["optimizer_state_dict"]
    names = {n for n, _ in model.named_parameters()}
    assert opt["step_count"] == 2
    assert set(opt["exp_avg"]) == set(opt["exp_avg_sq"]) == names


def test_jax_load_checkpoint_reads_the_port_file(tmp_path, setup):
    """JAX load_checkpoint (its pure-Python reader) takes the port's file:
    the parameters equal the port model's, the optimizer entry is skipped,
    step and epoch are read."""
    cfg, _, port_cfg = setup
    model, optimizer = _trained(port_cfg, 4)
    path = pckpt.save_checkpoint(str(tmp_path), "port", model, port_cfg,
                                 optimizer=optimizer, step=2, epoch=5)
    missing, unexpected, step, epoch, loaded = _jax_report(path, cfg)
    assert (missing, unexpected, step, epoch) == ([], [], 2, 5)
    want = {k: v for k, v in model.state_dict().items()}
    got = state_dict_from_jax_params(loaded, port_cfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # its reader parses the nested optimizer entry too
    payload = tser.load(path)
    assert payload["optimizer_state_dict"]["step_count"] == 2


def test_jax_optimizer_state_resumes_in_the_port(tmp_path, setup):
    """A JAX checkpoint with its pickled AdamWRef state: count becomes
    step_count and mu / nu the moments, under the port's names."""
    from youtube_vln_tpu.training.optimization import AdamWRefState
    cfg, params, port_cfg = setup
    rng = np.random.default_rng(0)
    mu = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda x: rng.random(size=x.shape).astype(np.float32), params)
    state = AdamWRefState(count=np.asarray(6, np.int32), mu=mu, nu=nu)
    path = jckpt.save_checkpoint(str(tmp_path), "jax", params, cfg,
                                 opt_state=state, step=6, epoch=1)
    model, optimizer = _trained(port_cfg, 3, steps=0)
    assert pckpt.load_checkpoint(path, model, optimizer) == ([], [], 6, 1)
    assert optimizer.step_count == 6
    want_m = state_dict_from_jax_params(mu, port_cfg)
    want_v = state_dict_from_jax_params(nu, port_cfg)
    for name, p in model.named_parameters():
        assert torch.equal(optimizer.state[p]["exp_avg"], want_m[name]), name
        assert torch.equal(optimizer.state[p]["exp_avg_sq"], want_v[name]), name


def test_disallowed_global_in_the_optimizer_blob_is_refused(tmp_path, setup):
    cfg, params, port_cfg = setup
    path = jckpt.save_checkpoint(str(tmp_path), "jax", params, cfg,
                                 opt_state={"m": np.ones(3, np.float32)})
    payload = tser.load(path)
    # a pickle that would call os.system on load
    payload["jax_optimizer_state"] = (b"\x80\x04\x95\x1c\x00\x00\x00\x00\x00\x00"
                                      b"\x00\x8c\x02os\x94\x8c\x06system\x94"
                                      b"\x93\x94\x8c\x04true\x94\x85\x94R\x94.")
    tser.save(payload, path)
    model, optimizer = _trained(port_cfg, 3, steps=0)
    import pickle
    with pytest.raises(pickle.UnpicklingError, match="os.system"):
        pckpt.load_checkpoint(path, model, optimizer)
    # a blob of another optimizer is refused too, by type
    jckpt.save_checkpoint(str(tmp_path), "other", params, cfg,
                          opt_state={"m": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="AdamWRef"):
        pckpt.load_checkpoint(str(tmp_path / "other.bin"), model, optimizer)
