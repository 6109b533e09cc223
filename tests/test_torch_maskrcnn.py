"""The port's Mask R-CNN detector (youtube_vln_tpu_torch/pipeline/
maskrcnn.py, the step-5b driver of pipeline/filters.py) against the JAX
package's, both from the random torchvision-layout state dict of
``tests/test_maskrcnn.py`` (the port loads it as it is, the JAX package
through ``params_from_torch_state_dict``), in f32 on the CPU: backbone +
FPN levels, RPN outputs and box head 1e-4 (of the largest output) at 64 x 96
with ``resize=False``, ``roi_align`` 1e-5, the 720p resize to 749 x 1333
1e-5, ``detect`` labels equal, scores 1e-3 and boxes 1e-3 of the largest
coordinate (the box head's logits and deltas agree to 1e-4 of the largest,
and the softmax and the decode, by exp and the box size, amplify that), the
driver's JSON byte-equal;
the carrier of the JAX tree (FrozenBN folded) exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_maskrcnn import _rand_sd

from youtube_vln_tpu.pipeline import filters as JF
from youtube_vln_tpu.pipeline import maskrcnn as JM
from youtube_vln_tpu.pipeline import places365 as JP
from youtube_vln_tpu_torch.models.weights import (alexnet_state_dict_from_jax_params,
                                                  maskrcnn_state_dict_from_jax_params)
from youtube_vln_tpu_torch.pipeline import filters as PF
from youtube_vln_tpu_torch.pipeline import maskrcnn as PM
from youtube_vln_tpu_torch.pipeline import places365 as PP

CPU = "cpu"


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets():
    sd = _rand_sd(np.random.default_rng(0))
    model = PM.MaskRCNN(device=CPU)
    model.load_state_dict(dict(sd), strict=True)
    return JM.params_from_torch_state_dict(sd), model


def test_backbone_fpn_rpn_boxhead_match_jax(nets):
    params, model = nets
    rng = np.random.default_rng(1)
    img = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    want = JM.backbone_fpn(params, jnp.asarray(img))
    want_rpn = JM.rpn_head(params, want)
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    with torch.inference_mode():
        got = PM.backbone_fpn(model, x)
        got_rpn = PM.rpn_head(model, got)
    assert [tuple(g.shape[2:]) for g in got] == [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for g, w in zip(got, want):
        close(nhwc(g), w, 1e-4)
    for (go, gd), (wo, wd) in zip(got_rpn, want_rpn):
        close(nhwc(go), wo, 1e-4)
        close(nhwc(gd), wd, 1e-4)
    pooled = rng.normal(size=(5, 7, 7, 256)).astype(np.float32)
    w_cls, w_box = JM.box_head(params, jnp.asarray(pooled))
    with torch.inference_mode():
        g_cls, g_box = PM.box_head(model, torch.from_numpy(
            np.ascontiguousarray(pooled.transpose(0, 3, 1, 2))))
    close(g_cls.numpy(), w_cls, 1e-4)
    close(g_box.numpy(), w_box, 1e-4)


def test_roi_align_matches_jax():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(24, 32, 8)).astype(np.float32)
    rois = np.asarray([
        [4.0, 4.0, 60.0, 40.0],
        [0.0, 0.0, 10.0, 10.0],
        [-6.0, -6.0, 20.0, 30.0],      # partially out of bounds
        [100.0, 80.0, 140.0, 120.0],   # fully below/right (clamps/zeros)
        [13.3, 7.7, 14.1, 9.9],        # sub-bin-size roi (min 1.0 width)
    ], np.float32)
    want = JM.roi_align(jnp.asarray(feat), jnp.asarray(rois), 0.25, 7, 2)
    got = PM.roi_align(torch.from_numpy(np.ascontiguousarray(feat.transpose(2, 0, 1))),
                       torch.from_numpy(rois), 0.25, 7, 2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_720p_resize_matches_jax(nets):
    params, model = nets
    img = np.random.default_rng(3).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    want, w_hw, w_orig = JM.MaskRCNNDetector(params)._preprocess(img, True)
    got, g_hw, g_orig = PM.MaskRCNNDetector(model, device=CPU)._preprocess(img, True)
    assert (g_hw, g_orig) == (w_hw, w_orig) == ((749, 1333), (720, 1280))
    assert tuple(got.shape) == (3, 768, 1344)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("resize", [False, True], ids=["as-is", "resized"])
def test_detect_matches_jax(nets, resize):
    params, model = nets
    img = np.random.default_rng(4).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    kw = dict(min_size=48, max_size=80)
    want = JM.MaskRCNNDetector(params, **kw).detect(img, resize=resize)
    det = PM.MaskRCNNDetector(model, device=CPU, **kw)
    got = det.detect(img, resize=resize)
    assert len(want["labels"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    close(got["boxes"], want["boxes"], 1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-3, rtol=0)
    assert set(det.last_timing) == {"device_s", "host_s"}
    assert PM.person_flags_for_frames(det, [img]) == [
        JM.MaskRCNNDetector(params, **kw).classify_person(img)]


def test_run_maskrcnn_filter_json_byte_equal(nets, tmp_path):
    params, model = nets
    from PIL import Image
    rng = np.random.default_rng(5)
    frames_dir = tmp_path / "raw_frames"
    for vid in ("vidA", "vidB"):
        d = frames_dir / vid
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(
                d / f"{i:04d}.jpg")
    alex_params = jax.tree_util.tree_map(
        np.asarray, JP.init_alexnet_params(jax.random.PRNGKey(0), 365))
    alex = PP.AlexNet(365, device=CPU)
    alex.load_state_dict(alexnet_state_dict_from_jax_params(alex_params), strict=True)
    is_indoor = rng.integers(0, 2, 365).astype(bool)
    kw = dict(min_size=64, max_size=96)
    assert JF.run_maskrcnn_filter(frames_dir, tmp_path / "jax", alex_params, is_indoor,
                                  JM.MaskRCNNDetector(params, **kw)) == 2
    det = PM.MaskRCNNDetector(model, device=CPU, **kw)
    assert PF.run_maskrcnn_filter(frames_dir, tmp_path / "port", alex, is_indoor, det,
                                  device=CPU) == 2
    for vid in ("vidA", "vidB"):
        rel = f"{vid}/{vid}.json"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert PF.run_maskrcnn_filter(frames_dir, tmp_path / "port", alex, is_indoor, det,
                                  device=CPU) == 0


def test_state_dict_layouts_and_jax_carrier(nets):
    """The newer torchvision layout (``inner_blocks.i.0``,
    ``rpn.head.conv.0.0``) with a mask branch loads strictly into the same
    weights, and the JAX tree's carrier gives back the folded BN exactly."""
    params, model = nets
    sd = model.state_dict()
    newer = {}
    for k, v in sd.items():
        k2 = k
        for kind in ("inner_blocks", "layer_blocks"):
            for i in range(4):
                k2 = k2.replace(f"fpn.{kind}.{i}.", f"fpn.{kind}.{i}.0.")
        k2 = k2.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        newer[k2] = v
    newer["roi_heads.mask_predictor.mask_fcn_logits.weight"] = torch.zeros(91, 256, 1, 1)
    newer["roi_heads.mask_head.mask_fcn1.weight"] = torch.zeros(256, 256, 3, 3)
    other = PM.MaskRCNN(device=CPU)
    other.load_state_dict(newer, strict=True)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k

    carried = PM.MaskRCNN(device=CPU)
    carried.load_state_dict(maskrcnn_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 3, 64, 64)).astype(np.float32))
    with torch.inference_mode():
        a, b = PM.backbone_fpn(model, x), PM.backbone_fpn(carried, x)
    for u, v in zip(a, b):
        close(u.numpy(), v.numpy(), 1e-5)
    bn = carried.backbone.body.bn1
    scale = bn.weight * (bn.running_var + bn.eps).rsqrt()
    assert torch.equal(scale, bn.weight)       # var + eps rounds to 1
