"""The LayerNorm kernels of youtube_vln_tpu_torch/ops/csrc/layer_norm.cu on
the card, against their plain version (ops/layer_norm.py): the model's
widths and odd ones, bf16 and f32, a second launch bitwise the first, and
``layer_norm`` under autograd on a strided input.  Marked ``cuda``: they
skip without a card (the kernels need nvcc and a GPU).

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm_card.py
"""
import pytest
import torch

from youtube_vln_tpu_torch.ops import layer_norm as LN

SHAPES = [(5760, 768), (1001, 1024), (3, 64), (33, 1000), (7, 8)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(card, n, d, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = (3.0 * torch.randn(n, d, generator=g, device=card) + 0.5).to(dtype)
    dy = torch.randn(n, d, generator=g, device=card).to(dtype)
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=card)
    b = 0.1 * torch.randn(d, generator=g, device=card)
    return x, dy, w, b


def _close(name, got, want, dtype):
    """bf16: one bf16 ulp of the value (the same f32 value to a few ulps
    rounds to neighbouring bf16 numbers at most) beside an f32 floor of
    1e-5 x the largest value; f32: that floor alone."""
    got, want = got.float(), want.float()
    tol = torch.full_like(want, 1e-5 * float(want.abs().max()))
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -120))) - 7)
        tol = torch.maximum(ulp, tol)
    err = (got - want).abs()
    assert bool((err <= tol).all()), (name, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", SHAPES)
def test_kernels_match_the_plain_version(card, n, d, dtype):
    x, dy, w, b = _operands(card, n, d, dtype)
    y, rows = LN._fwd(x, w, b)
    _close("y", y, LN.layer_norm_reference(x, w, b), dtype)
    got = LN._bwd(rows, w, dy)
    want = LN.layer_norm_bwd_reference(x, w, dy)
    for name, g, r in zip(("dx", "dw", "db"), got, want):
        assert g.dtype == r.dtype, name
        _close(name, g, r, dtype if name == "dx" else torch.float32)
    again = LN._bwd(rows, w, dy)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_layer_norm_under_autograd_on_a_strided_input(card):
    x, dy, w, b = _operands(card, 2 * 808, 1024, torch.bfloat16, seed=1)
    x = x.view(2, 808, 1024).transpose(0, 1)          # not contiguous
    dy = dy.view(808, 2, 1024)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(),
              b.clone().requires_grad_()]
    LN.reset_launch_counts()
    y = LN.layer_norm(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert LN.LAUNCHES == {"layer_norm_fwd": 1, "layer_norm_bwd": 1}
    assert y.shape == x.shape and y.dtype == x.dtype
    _close("y", y, LN.layer_norm_reference(x, w, b), torch.bfloat16)
    for name, g, r in zip(("dx", "dw", "db"), got,
                          LN.layer_norm_bwd_reference(x, w, dy)):
        assert g.shape == r.shape, name
        _close(name, g, r, torch.bfloat16 if name == "dx" else torch.float32)
    with torch.no_grad():
        assert torch.equal(LN.layer_norm(x, w, b), y)
