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


def test_url_and_missing_paths_raise(tmp_path, setup):
    model = Lily(setup[2], device="cpu")
    with pytest.raises(ValueError, match="URL"):
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
