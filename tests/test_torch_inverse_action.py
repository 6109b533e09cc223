"""The port's inverse action model (youtube_vln_tpu_torch/pipeline/
inverse_action.py) against the JAX package's, in f32 on the CPU: the head's
forward 1e-5 on the carried weights (fc1's rows put in CHW order), three
``torch.optim.Adam`` steps against ``optax.adam`` on the same gradients 1e-6,
``encode_frames`` 1e-4 (of the largest), ``predict_actions`` equal, the
profile JSONs byte-equal, and the head learning a separable task (accuracy
above 0.8; the dropout masks are the port's own, so the runs match only
statistically)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from youtube_vln_tpu.pipeline import inverse_action as JI
from youtube_vln_tpu.pipeline import places365 as JP
from youtube_vln_tpu_torch.models.weights import inverse_state_dict_from_jax_params
from youtube_vln_tpu_torch.pipeline import inverse_action as PI
from youtube_vln_tpu_torch.pipeline import places365 as PP

CPU = "cpu"
C_FEAT = 8


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _pair(seed=0, feat_channels=C_FEAT):
    params = jax.tree_util.tree_map(
        np.asarray, JI.init_inverse_params(jax.random.PRNGKey(seed), feat_channels))
    model = PI.InverseActionHead(feat_channels, device=CPU)
    model.load_state_dict(inverse_state_dict_from_jax_params(params), strict=True)
    return params, model


def _feats(seed, n, c=C_FEAT):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 7, 7, c)).astype(np.float32) for _ in range(2)]


def test_forward_matches_jax():
    params, model = _pair()
    fk, fk1 = _feats(1, 5)
    want = JI.inverse_forward(params, jnp.asarray(fk), jnp.asarray(fk1))
    with torch.inference_mode():
        got = model(nchw(fk), nchw(fk1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_adam_steps_match_optax():
    params, model = _pair(seed=2)
    lr = 3e-3
    tx = optax.adam(lr)
    state = tx.init(params)
    opt = PI.make_optimizer(model, lr)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        carried = inverse_state_dict_from_jax_params(grads)
        for name, p in model.named_parameters():
            p.grad = carried[name].clone()
        opt.step()
    want = inverse_state_dict_from_jax_params(params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


def test_head_learns_a_separable_task():
    rng = np.random.default_rng(4)

    def make_batch(bs=32):
        y = rng.integers(0, 3, size=bs)
        fk = rng.normal(size=(bs, C_FEAT, 7, 7)).astype(np.float32)
        shift = np.zeros_like(fk)
        shift[np.arange(bs), y] = 2.0
        return fk, fk + shift, y

    def batches():
        while True:
            yield make_batch()

    model, losses = PI.train_inverse_model(batches(), steps=60, lr=3e-3,
                                           feat_channels=C_FEAT, seed=0, device=CPU)
    assert losses[-1] < losses[0]
    fk, fk1, y = make_batch(64)
    with torch.inference_mode():
        logits = model(torch.from_numpy(fk), torch.from_numpy(fk1))
    acc = float((logits.argmax(-1).numpy() == y).mean())
    assert acc > 0.8, acc


def test_encode_frames_and_predict_actions_match_jax():
    backbone = PP.WideResNet18(3, device=CPU).init_weights(5)
    backbone_params = jax.tree_util.tree_map(
        np.asarray, JP.params_from_torch_state_dict(backbone.state_dict()))
    frames = np.random.default_rng(6).integers(0, 256, (4, 48, 64, 3), dtype=np.uint8)
    want = JI.encode_frames(backbone_params, frames, batch_size=3)
    got = PI.encode_frames(backbone, frames, batch_size=3, device=CPU)
    assert got.shape == (4, 512, 7, 7)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.transpose(0, 2, 3, 1) - want).max() <= 1e-4 * scale

    params, model = _pair(seed=7, feat_channels=512)
    names = PI.predict_actions(model, list(got), device=CPU)
    assert names == JI.predict_actions(params, list(want))
    assert len(names) == 3 and set(names) <= set(PI.ACTIONS)
    assert PI.predict_actions(model, list(got[:1]), device=CPU) == []


def test_action_profiles_byte_equal(tmp_path):
    caps = {"%04d.jpg" % i: [f"room {i}"] for i in (1, 2, 3, 4, 5)}
    kw = dict(trajectories={"0": [1, 3, 5], "1": [2, 4]},
              actions_by_frame={1: "left", 3: "forward", 2: "right"}, captions=caps)
    a = JI.write_action_profiles(tmp_path / "jax", "vid7", **kw)
    b = PI.write_action_profiles(tmp_path / "port", "vid7", **kw)
    assert b.read_bytes() == a.read_bytes()
    assert ((b.parent / "captions_pro.json").read_bytes()
            == (a.parent / "captions_pro.json").read_bytes())
