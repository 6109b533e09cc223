"""The port's CLIP encoders (youtube_vln_tpu_torch/pipeline/clip_model.py)
against the JAX package's at the tiny ``ClipConfig`` of
``tests/test_pipeline.py:test_clip_matches_hf_reference``, in f32 on the
CPU: image and text features 1e-4 (of the largest), from a HuggingFace
``CLIPModel`` state dict loaded strictly and from the port's own init (the
JAX tree made by the JAX importer, carried back exactly);
the bicubic preprocessor against ``jax.image.resize`` 1e-5; the step-6a
TSV driver's rows and resume."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from youtube_vln_tpu.pipeline import clip_model as JC
from youtube_vln_tpu_torch.models.weights import clip_state_dict_from_jax_params
from youtube_vln_tpu_torch.pipeline import clip_model as PC

CPU = "cpu"
KW = dict(image_size=32, patch_size=8, v_hidden=32, v_layers=2, v_heads=2,
          t_hidden=24, t_layers=2, t_heads=2, vocab_size=50, context_length=16,
          proj_dim=20)


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pixels = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    # eot (49, the largest id) at a distinct position per row
    tokens = rng.integers(1, 48, size=(3, 16)).astype(np.int32)
    for i, pos in enumerate((5, 11, 15)):
        tokens[i, pos] = 49
        tokens[i, pos + 1:] = 0
    return pixels, tokens


def _compare(params, jcfg, model, seed=0):
    pixels, tokens = _inputs(seed)
    want_img = JC.clip_image_features(params, jcfg, jnp.asarray(pixels))
    want_txt = JC.clip_text_features(params, jcfg, jnp.asarray(tokens))
    with torch.inference_mode():
        got_img = PC.clip_image_features(model, torch.from_numpy(
            np.ascontiguousarray(pixels.transpose(0, 3, 1, 2))))
    got_txt = PC.text_features(model, tokens, device=CPU)
    close(got_img.numpy(), want_img, 1e-4)
    close(got_txt, want_txt, 1e-4)


def _pair(seed):
    """The port's model from the seed and the JAX tree that the JAX
    package's importer (``params_from_hf_state_dict``) makes of it."""
    model = PC.ClipModel(PC.ClipConfig(**KW), device=CPU).init_weights(seed)
    params = jax.tree_util.tree_map(
        np.asarray, JC.params_from_hf_state_dict(model.state_dict()))
    return params, model


def test_features_match_jax_and_the_carrier_inverts_the_importer():
    params, model = _pair(0)
    _compare(params, JC.ClipConfig(**KW), model)
    sd = clip_state_dict_from_jax_params(params)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_hf_state_dict_loads_strictly_and_matches_jax():
    transformers = pytest.importorskip("transformers")
    vcfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8, hidden_act="quick_gelu")
    tcfg = transformers.CLIPTextConfig(
        hidden_size=24, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=2, vocab_size=50, max_position_embeddings=16,
        hidden_act="quick_gelu", eos_token_id=49)
    torch.manual_seed(0)
    hf = transformers.CLIPModel(transformers.CLIPConfig.from_text_vision_configs(
        tcfg, vcfg, projection_dim=20)).eval()
    sd = hf.state_dict()
    model = PC.ClipModel(PC.ClipConfig(**KW), device=CPU)
    # an HF checkpoint of some versions also carries the position_ids buffers
    model.load_state_dict({**sd, "text_model.embeddings.position_ids":
                           torch.arange(16)[None]}, strict=True)
    _compare(JC.params_from_hf_state_dict(sd), JC.ClipConfig(**KW), model, seed=1)


@pytest.mark.parametrize("shape", [(1, 720, 1280), (2, 48, 64), (1, 300, 200)],
                         ids=["720p", "upsample", "portrait"])
def test_bicubic_preprocessor_matches_jax(shape):
    frames = np.random.default_rng(2).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = JC.preprocess_images(frames, 224)
    got = PC.preprocess_images(frames, 224, device=CPU)
    assert got.shape == (shape[0], 3, 224, 224)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


def test_clip_tsv_build_and_resume(tmp_path):
    from PIL import Image
    jcfg = JC.ClipConfig(**KW)
    params, model = _pair(3)
    rng = np.random.default_rng(4)
    frames = tmp_path / "raw_frames"
    for v in range(2):
        (frames / f"vid{v}").mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
                frames / f"vid{v}" / ("%04d.jpg" % i))
    assert PC.build_clip_tsv(model, frames, tmp_path / "port.tsv", batch_size=2,
                             device=CPU) == 6
    assert JC.build_clip_tsv(params, jcfg, frames, tmp_path / "jax.tsv") == 6
    exist, feats = PC.read_clip_tsv(tmp_path / "port.tsv", 20)
    j_exist, j_feats = JC.read_clip_tsv(tmp_path / "jax.tsv", 20)
    assert exist == j_exist and list(feats) == list(j_feats)
    for k in feats:
        close(feats[k], j_feats[k], 1e-4)
    Image.fromarray(np.zeros((24, 32, 3), np.uint8)).save(frames / "vid0" / "0009.jpg")
    assert PC.build_clip_tsv(model, frames, tmp_path / "port.tsv", device=CPU) == 1
    assert len(PC.read_clip_tsv(tmp_path / "port.tsv", 20)[1]) == 7
