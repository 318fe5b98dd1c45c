"""The port's M-RoPE (``repro_torch.models.layers.apply_mrope`` and the
(B, S) -> (3, B, S) broadcast of ``attention._rope_or_mrope``) against
the reference's ``repro.models.layers.apply_mrope`` on the same numpy
inputs: qwen2-vl-2b's sections (16, 24, 24) and the reduced config's
(4, 6, 6), at image positions (Qwen2-VL's rule,
``anchors.image_positions``), in float32 and bf16; gradients against
``jax.grad``; the reference's two M-RoPE tests case for case.

Tolerances, as ``tests/test_torch_lm_layers.py`` holds RoPE: float32
within 1e-6 (the angles are the same float32 products; ``sin``/``cos``
of two libraries differ by an ulp), bf16 within one bf16 ulp of |x| <= 8
(2^-4, the output rounded once in each framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import get_reduced_config
from repro_torch.models import anchors as A
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

F32 = dict(atol=1e-6, rtol=1e-6)
BF16_ULP = 2.0 ** -4
#: (sections, head dim, theta, prompt layout: text, image rows and
#: columns, text): qwen2-vl-2b's and the reduced config's.
CASES = {"qwen2-vl-2b": ((16, 24, 24), 128, 1e6, (16, 8, 6, 34)),
         "reduced": ((4, 6, 6), 32, 1e6, (5, 4, 4, 11))}


def _inputs(sections, head_dim, layout, seed=0):
    rng = np.random.default_rng(seed)
    pos = A.image_positions(*layout)                       # (3, S)
    s = pos.shape[1]
    x = rng.standard_normal((2, s, 3, head_dim)).astype(np.float32)
    # the second sequence's image sits elsewhere: its streams shifted
    pos3 = np.stack([pos, pos + 7], axis=1).astype(np.int32)  # (3, 2, S)
    return x, pos3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mrope_matches_reference(case, dtype):
    sections, hd, theta, layout = CASES[case]
    x, pos3 = _inputs(sections, hd, layout)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(JL.apply_mrope(jx, jnp.asarray(pos3), theta,
                                     sections).astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = TL.apply_mrope(tx, torch.as_tensor(pos3), theta, sections)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        assert np.abs(got.float().numpy() - want).max() <= BF16_ULP


@pytest.mark.parametrize("case", list(CASES))
def test_mrope_gradient_matches_jax(case):
    sections, hd, theta, layout = CASES[case]
    x, pos3 = _inputs(sections, hd, layout, seed=1)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(JL.apply_mrope(
        a, jnp.asarray(pos3), theta, sections) * ct))(jnp.asarray(x)))
    tx = torch.as_tensor(x).requires_grad_(True)
    (TL.apply_mrope(tx, torch.as_tensor(pos3), theta, sections)
     * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, **F32)


def test_mrope_asserts_the_sections_fill_half_the_head():
    with pytest.raises(AssertionError):
        TL.apply_mrope(torch.zeros(1, 2, 1, 32), torch.zeros(3, 1, 2),
                       1e4, (4, 6, 4))


def test_mrope_matches_rope_for_text():
    """The reference's test: with t = h = w positions, M-RoPE equals
    plain RoPE (here bitwise: the same float32 angles)."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 8, 4, 32)).astype(np.float32))
    pos = torch.arange(8).expand(2, 8)
    pos3 = pos[None].expand(3, 2, 8)
    y1 = TL.apply_rope(x, pos, 1e4)
    y2 = TL.apply_mrope(x, pos3, 1e4, (4, 6, 6))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    assert torch.equal(y1, y2)


def test_mrope_distinguishes_spatial_positions():
    """The reference's test: another h stream moves the output."""
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, 4, 2, 32)).astype(np.float32))
    t = torch.zeros(1, 4, dtype=torch.int32)
    h = torch.arange(4, dtype=torch.int32)[None]
    w = torch.zeros(1, 4, dtype=torch.int32)
    y = TL.apply_mrope(x, torch.stack([t, h, w]), 1e4, (4, 6, 6))
    y0 = TL.apply_mrope(x, torch.stack([t, w, w]), 1e4, (4, 6, 6))
    assert float((y - y0).abs().max()) > 1e-3


def test_sections_take_their_own_streams():
    """Frequency band i of the half rotates by the stream its section
    names: moving only the w stream leaves the t and h bands as they
    were, bitwise."""
    sections = (4, 6, 6)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1, 6, 2, 32)).astype(np.float32))
    pos3 = torch.as_tensor(A.image_positions(1, 2, 2, 1))[:, None]
    moved = pos3.clone()
    moved[2] += 5
    a = TL.apply_mrope(x, pos3, 1e4, sections)
    b = TL.apply_mrope(x, moved, 1e4, sections)
    for lo, hi in ((0, 10), (16, 26)):          # t and h bands, both halves
        assert torch.equal(a[..., lo:hi], b[..., lo:hi])
    assert not torch.equal(a[..., 10:16], b[..., 10:16])


@pytest.mark.parametrize("rank", [2, 3], ids=["text_2d", "streams_3d"])
def test_rope_or_mrope_broadcasts_text_positions(rank):
    """``_rope_or_mrope`` on (B, S) positions rotates as the reference's
    does (its broadcast to t = h = w), and on (3, B, S) ones as
    ``apply_mrope``; both against the reference's function."""
    from repro.configs import get_reduced_config as jax_config
    from repro.models import attention as JA

    cfg = get_reduced_config("qwen2-vl-2b", dtype="float32")
    jcfg = jax_config("qwen2-vl-2b", dtype="float32")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 4, cfg.resolved_head_dim)).astype(
        np.float32)
    pos = rng.integers(0, 50, (2, 9)).astype(np.int32)
    if rank == 3:
        pos = np.stack([pos, pos + 1, pos + 2])
    want = np.asarray(JA._rope_or_mrope(jcfg, jnp.asarray(x),
                                        jnp.asarray(pos)))
    got = TA._rope_or_mrope(cfg, torch.as_tensor(x), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if rank == 2:
        three = torch.as_tensor(pos)[None].expand(3, 2, 9)
        assert torch.equal(got, TL.apply_mrope(
            torch.as_tensor(x), three, cfg.rope_theta, cfg.mrope_sections))
        # t = h = w: plain RoPE on the same positions, bitwise
        plain = dataclasses.replace(cfg, mrope_sections=())
        assert torch.equal(got, TA._rope_or_mrope(
            plain, torch.as_tensor(x), torch.as_tensor(pos)))


def test_image_positions_follow_qwen2_vl():
    """16 text tokens, a 48 x 48 image, 1,776 text tokens: the image at
    t = 16, h and w 16 + row and column; the text after it from 64."""
    pos = A.image_positions(16, 48, 48, 1776)
    assert pos.shape == (3, 4096) and pos.dtype == np.int32
    np.testing.assert_array_equal(pos[:, :16], np.tile(np.arange(16), (3, 1)))
    img = pos[:, 16:16 + 2304]
    assert (img[0] == 16).all()
    np.testing.assert_array_equal(img[1], 16 + np.repeat(np.arange(48), 48))
    np.testing.assert_array_equal(img[2], 16 + np.tile(np.arange(48), 48))
    np.testing.assert_array_equal(pos[:, 2320:],
                                  np.tile(64 + np.arange(1776), (3, 1)))
    assert pos.max() == 1839
