"""The port's optimizer and schedules (youtube_vln_tpu_torch/training/
optimization.py) against the JAX package's (training/optimization.py)."""
import jax
import numpy as np
import pytest
import torch

from youtube_vln_tpu.config import RunConfig as JaxRunConfig
from youtube_vln_tpu.config import tiny_config as jax_tiny_config
from youtube_vln_tpu.models import init_lily_params
from youtube_vln_tpu.training import optimization as jo
from youtube_vln_tpu_torch.config import RunConfig, tiny_config
from youtube_vln_tpu_torch.models import Lily
from youtube_vln_tpu_torch.models.weights import state_dict_from_jax_params
from youtube_vln_tpu_torch.training import optimization as to

HEADS = dict(ranking=True, traj_judge=True, masked_vision=True,
             masked_language=True)


@pytest.mark.parametrize("name", sorted(jo.SCHEDULES))
def test_schedules_match_jax_over_50_steps(name):
    got = to.SCHEDULES[name](4e-5, 10.0, 40.0)
    want = jo.SCHEDULES[name](4e-5, 10.0, 40.0)
    for step in range(50):
        # the JAX schedules run in f32: 1e-6 of the base rate
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * 4e-5, err_msg=f"{name} step {step}")


@pytest.mark.parametrize("overrides", [
    dict(), dict(lr_schedule="warmup_cosine", cooldown_factor=1.0),
    dict(ConstantLR=True), dict(no_scheduler=True),
    dict(warmup_proportion=0.0, num_epochs=3)])
def test_make_schedule_matches_jax(overrides):
    """Optimizer steps per epoch, warm-up proportion and the cooldown
    stretch of the total."""
    got = to.make_schedule(RunConfig(**overrides), steps_per_epoch=7)
    want = jo.make_schedule(JaxRunConfig(**overrides), steps_per_epoch=7)
    for step in range(50):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * 4e-5, err_msg=f"step {step}")


def _jax_tree_to_port(tree, cfg):
    """A JAX-layout parameter tree (numpy leaves) keyed by the port's
    parameter names."""
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, tree), cfg)


def test_no_decay_set_matches_the_jax_mask():
    """The reference's name rule on the port's names decays exactly what the
    JAX package's no_decay_mask decays: the connection layers'
    biOutput.LayerNorm1/2.weight (JAX ln1/ln2) are decayed."""
    jax_cfg, cfg = jax_tiny_config(**HEADS), tiny_config(**HEADS)
    params = init_lily_params(jax.random.PRNGKey(0), jax_cfg)
    mask = jax.tree_util.tree_map(lambda nd, p: np.full(np.shape(p), float(nd), np.float32),
                                  jo.no_decay_mask(params), params)
    want = {k: bool(v.reshape(-1)[0]) for k, v in _jax_tree_to_port(mask, cfg).items()}
    names = [n for n, _ in Lily(cfg, device="cpu").named_parameters()]
    assert len(names) == len(set(names))
    assert {n: to.is_no_decay(n) for n in names} == {n: want[n] for n in names}
    assert not to.is_no_decay("bert.encoder.c_layer.0.biOutput.LayerNorm1.weight")
    assert to.is_no_decay("bert.encoder.c_layer.0.biOutput.LayerNorm1.bias")


def test_decoder_weight_is_one_parameter_updated_once():
    model = Lily(tiny_config(**HEADS), device="cpu").init_weights(0)
    groups = to.param_groups(model, 1e-2)
    ids = [id(p) for g in groups for p in g["params"]]
    assert len(ids) == len(set(ids))
    assert id(model.cls.predictions.decoder.weight) in ids


def test_adamw_ref_matches_jax_apply():
    """Three AdamWRef updates against adamw_ref.apply on equal gradients
    (one parameter without a gradient takes zeros, as the JAX tree update
    does), 1e-6."""
    jax_cfg, cfg = jax_tiny_config(**HEADS), tiny_config(**HEADS)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_lily_params(jax.random.PRNGKey(1), jax_cfg))
    model = Lily(cfg, device="cpu")
    model.load_state_dict(_jax_tree_to_port(params, cfg), strict=True)
    schedule_j = jo.warmup_linear_schedule(1e-3, 1.0, 10.0)
    tx = jo.adamw_ref(schedule_j, weight_decay=1e-2)
    opt = to.AdamWRef(to.param_groups(model, 1e-2),
                      to.warmup_linear_schedule(1e-3, 1.0, 10.0), weight_decay=1e-2)
    state = tx.init(params)
    rng = np.random.default_rng(2)
    skip = "judge.weight"
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        grads["judge"]["w"] = np.zeros_like(grads["judge"]["w"])
        port_grads = _jax_tree_to_port(grads, cfg)
        for name, p in model.named_parameters():
            p.grad = None if name == skip else port_grads[name].clone()
        opt.step()
        params, state = tx.apply(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, params)
    want = _jax_tree_to_port(params, cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_adamw_ref_reads_the_rate_at_the_completed_step_count():
    """LambdaLR semantics: the first step reads schedule(0), which warm-up
    sets to 0, so only the second step moves a parameter."""
    model = Lily(tiny_config(), device="cpu").init_weights(0)
    opt = to.AdamWRef(to.param_groups(model, 1e-2),
                      to.warmup_linear_schedule(1e-3, 2.0, 10.0), weight_decay=1e-2)
    before = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert opt.step_count == 1
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    opt.step()
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
