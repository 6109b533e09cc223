"""The port's Places365 classifiers (youtube_vln_tpu_torch/pipeline/
places365.py, the step-5a driver of pipeline/filters.py) against the JAX
package's, on weights carried over by ``models/weights.py`` and seeded numpy
inputs, in f32 on the CPU: WideResNet-18 logits, layer4 and pooled and the
ResNet-18 trunk 1e-4 (of the largest output), AlexNet 1e-4, the
preprocessors against ``jax.image.resize`` 1e-5, the votes equal and
``run_indoor_filter``'s artifacts byte-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.pipeline import filters as JF
from youtube_vln_tpu.pipeline import places365 as JP
from youtube_vln_tpu_torch.models.weights import (alexnet_state_dict_from_jax_params,
                                                  places_state_dict_from_jax_params)
from youtube_vln_tpu_torch.pipeline import filters as PF
from youtube_vln_tpu_torch.pipeline import places365 as PP

CPU = "cpu"


def close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _places(num_classes=365, seed=0):
    """The port's WideResNet-18 from the seed, BN statistics away from
    identity, and the JAX tree that the JAX package's own importer
    (``params_from_torch_state_dict``) makes of its state dict."""
    model = PP.WideResNet18(num_classes, device=CPU).init_weights(seed)
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(1 + 0.1 * rng.normal(size=c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.normal(size=c)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.normal(size=c)))
                m.running_var.copy_(torch.from_numpy(1 + 0.2 * rng.random(c)))
    params = jax.tree_util.tree_map(np.asarray,
                                    JP.params_from_torch_state_dict(model.state_dict()))
    return params, model


def _alexnet(seed):
    model = PP.AlexNet(365, device=CPU).init_weights(seed)
    params = jax.tree_util.tree_map(
        np.asarray, JP.alexnet_params_from_torch_state_dict(model.state_dict()))
    return params, model


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_wideresnet18_matches_jax():
    params, model = _places()
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    logits, layer4, pooled = jax.jit(JP.places_forward)(params, jnp.asarray(x))
    with torch.inference_mode():
        t_logits, t_layer4, t_pooled = PP.places_forward(model, nchw(x))
    assert t_layer4.shape == (2, 512, 4, 4)
    close(t_logits.numpy(), logits, 1e-4)
    close(nhwc(t_layer4), layer4, 1e-4)
    close(t_pooled.numpy(), pooled, 1e-4)


@pytest.mark.parametrize("maxpool", [True, False])
def test_resnet18_backbone_matches_jax(maxpool):
    params, model = _places(num_classes=5, seed=2)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(JP.resnet18_backbone_forward, static_argnames="maxpool")(
        params, jnp.asarray(x), maxpool=maxpool)
    with torch.inference_mode():
        got = PP.resnet18_backbone_forward(model, nchw(x), maxpool=maxpool)
    close(nhwc(got), want, 1e-4)


def test_alexnet_matches_jax():
    params, model = _alexnet(4)
    x = np.random.default_rng(5).normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = jax.jit(JP.alexnet_forward)(params, jnp.asarray(x))
    with torch.inference_mode():
        got = model(nchw(x))
    close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("shape,kind", [
    ((1, 720, 1280), "full"),          # 720p -> 224 x 224, antialiased
    ((2, 48, 64), "full"),             # upsampling -> 224 x 224
    ((1, 720, 1280), "crop256"),       # shorter side -> 256, crop 224
    ((1, 720, 1280), "crop224"),       # the inverse-action encoder's crop
], ids=["720p-224", "48x64-224", "720p-256-crop", "720p-224-crop"])
def test_preprocessors_match_jax_resize(shape, kind):
    frames = _frames(6, *shape)
    if kind == "full":
        want = JP.preprocess_images(frames)
        got = PP.preprocess_images(frames, device=CPU)
    else:
        r = int(kind[4:])
        want = JP.preprocess_images_crop(frames, resize=r, crop=224)
        got = PP.preprocess_images_crop(frames, resize=r, crop=224, device=CPU)
    assert got.shape == (shape[0], 3, 224, 224)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5, rtol=0)


def test_scorers_and_votes_equal():
    params, model = _places(num_classes=20, seed=7)
    rng = np.random.default_rng(8)
    labels_io = rng.integers(0, 2, size=20).astype(np.float64)
    classes = [f"class{i}" for i in range(20)]
    labels_attr = [f"attr{i}" for i in range(6)]
    w_attr = rng.normal(size=(6, 512)).astype(np.float32)
    frames = _frames(9, 3, 40, 60)
    kw = dict(labels_io=labels_io, classes=classes, labels_attribute=labels_attr,
              w_attribute=w_attr, num_cat=5, num_attr=4)
    want = JP.score_batch(params, JP.preprocess_images(frames), **kw)
    got = PP.score_batch(model, PP.preprocess_images(frames, device=CPU),
                         device=CPU, **kw)
    for g, w in zip(got, want):
        assert g["is_indoor"][1] == w["is_indoor"][1]
        assert g["is_indoor"][0] == pytest.approx(w["is_indoor"][0])
        assert [c for _, c in g["category"]] == [c for _, c in w["category"]]
        np.testing.assert_allclose([p for p, _ in g["category"]],
                                   [p for p, _ in w["category"]], atol=1e-5)
        assert [a for _, a in g["attributes"]] == [a for _, a in w["attributes"]]
    np.testing.assert_array_equal(PP.indoor_scores(model, frames, labels_io, device=CPU),
                                  JP.indoor_scores(params, frames, labels_io))
    is_indoor = rng.integers(0, 2, 20)
    np.testing.assert_allclose(
        PF.places365_indoor_probs(model, frames, is_indoor, batch_size=2, device=CPU),
        JF.places365_indoor_probs(params, frames, is_indoor, batch_size=2), atol=1e-5)


def test_alexnet_indoor_probs_equal():
    params, model = _alexnet(10)
    frames = _frames(11, 3, 96, 128)
    is_indoor = np.random.default_rng(12).integers(0, 2, 365).astype(bool)
    np.testing.assert_allclose(
        PP.alexnet_indoor_probs(model, frames, is_indoor, batch_size=2, device=CPU),
        JP.alexnet_indoor_probs(params, frames, is_indoor, batch_size=2), atol=1e-5)


def _write_frames(root, n_videos, n_frames, h=48, w=64, seed=13):
    from PIL import Image
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        for i in range(n_frames):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                d / ("%04d.jpg" % i))


def test_run_indoor_filter_artifacts_byte_equal(tmp_path):
    params, model = _places(num_classes=12, seed=14)
    frames = tmp_path / "raw_frames"
    _write_frames(frames, 2, 5)
    labels_io = np.random.default_rng(15).integers(0, 2, 12).astype(np.float64)
    n_jax = JF.run_indoor_filter(frames, tmp_path / "jax", params, labels_io,
                                 batch_size=3)
    n_port = PF.run_indoor_filter(frames, tmp_path / "port", model, labels_io,
                                  batch_size=3, device=CPU)
    assert n_jax == n_port == 2
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.tsv"))
    assert len(files) == 4
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    # resume: existing outputs are skipped
    assert PF.run_indoor_filter(frames, tmp_path / "port", model, labels_io,
                                device=CPU) == 0


@pytest.mark.parametrize("net", ["wideresnet18", "alexnet"])
def test_jax_tree_carriers_give_back_the_state_dict(net):
    """The carriers of ``models/weights.py`` invert the JAX importers: the
    JAX tree of a port state dict carries back to it exactly (AlexNet's
    first linear through the HWC -> CHW row permutation)."""
    if net == "wideresnet18":
        params, model = _places(num_classes=9, seed=17)
        sd = places_state_dict_from_jax_params(params)
    else:
        params, model = _alexnet(18)
        sd = alexnet_state_dict_from_jax_params(params)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_torchvision_keys_load_strictly():
    """A Places365 checkpoint (``module.`` prefix, BatchNorm without
    ``num_batches_tracked``) and a torchvision one load with strict=True."""
    _, model = _places(num_classes=7, seed=16)
    sd = model.state_dict()
    wrapped = {"module." + k: v for k, v in sd.items()
               if not k.endswith("num_batches_tracked")}
    other = PP.WideResNet18(7, device=CPU)
    other.load_state_dict(wrapped, strict=True)
    for k, v in other.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    alex = PP.AlexNet(365, device=CPU).init_weights(0)
    PP.AlexNet(365, device=CPU).load_state_dict(
        {"module." + k: v for k, v in alex.state_dict().items()}, strict=True)
