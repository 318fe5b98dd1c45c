"""``chip_smoke.py``'s ``roofline`` phase (9h), rehearsed on the CPU at a
reduced config: a stand-in for each of kernels D and E computes its
plain version out of the count's sight (as a ``ctypes`` launch is),
counts its launch and reports it to ``repro_torch.kernels._credit`` as
the real wrappers do, so the kernel path's count meets the plain
blockwise path's as on the card.  The gates' arithmetic at gemma2-2b's
full size is checked by hand; the power reading's median with
``nvidia-smi`` stood in."""

import itertools
import pathlib
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402

from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import _credit  # noqa: E402
from repro_torch.kernels import flash_attention as E  # noqa: E402
from repro_torch.kernels import rmsnorm as D  # noqa: E402
from repro_torch.models import flash, layers  # noqa: E402

TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "12",
              "--seq-len", "32", "--global-batch", "4", "--lr", "1e-2",
              "--warmup", "2"]
SEQ = 1024


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_ins(monkeypatch, credit=True):
    """Kernels D and E stood in on the CPU, reached by the forward as on
    the card (``flash_attention`` calling ``flash_attention_fwd``), each
    reporting its launches as the wrappers do (``credit=False``: E does
    not); where autograd records they defer to the real (plain) path,
    which launches nothing on the CPU."""
    real_fa, real_norm = flash.flash_attention, layers.rmsnorm_op

    def fake_fwd(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                 scale=None, return_stats=False, blocks=(512, 512)):
        kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                  scale=scale, return_stats=return_stats,
                  blocks=tuple(blocks))
        with _disable_current_modes():
            res = flash.blockwise_fwd(q, k, v, **kw)
        E.flash_attention_fwd.launches += 1
        if credit and _credit.active():
            _credit.credit("flash_attention", flash.blockwise_fwd,
                           (q, k, v), kw, (q, k, v),
                           res if return_stats else (res,))
        return res

    def fake_fa(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                q_block=512, kv_block=512, scale=None, p_bf16=False):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return real_fa(q, k, v, causal=causal, window=window,
                           logit_softcap=logit_softcap, q_block=q_block,
                           kv_block=kv_block, scale=scale)
        sq, skv = q.shape[1], k.shape[1]
        scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
        return flash.flash_attention_fwd(
            q, k, v, causal=causal, window=window,
            logit_softcap=logit_softcap, scale=scale,
            blocks=(min(q_block, sq), min(kv_block, skv)))

    def fake_norm(x, scale, eps=1e-6):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or scale.requires_grad):
            return real_norm(x, scale, eps=eps)
        x2 = x.reshape(-1, x.shape[-1])
        with _disable_current_modes():
            out = D.rmsnorm_ref(x2, scale, eps)
        D.rmsnorm_fused.launches += 1
        if _credit.active():
            _credit.credit("rmsnorm", D.rmsnorm_ref, (x2, scale, eps), {},
                           (x2, scale), (out,))
        return out.reshape(x.shape)

    monkeypatch.setattr(flash, "flash_attention", fake_fa)
    monkeypatch.setattr(flash, "flash_attention_fwd", fake_fwd)
    monkeypatch.setattr(layers, "rmsnorm_op", fake_norm)
    # the training step's backward runs the plain path on the CPU, which
    # launches nothing
    monkeypatch.setattr(CS, "train_launches", lambda cfg: {"D": 0, "E": 0})


def _cfg(d_model=512):
    """gemma2-2b's pattern (a local and a global layer) narrowed; at
    d 512 the projections outweigh the attention's whole diagonal
    blocks enough for the 5 % gate, as at full width."""
    return get_reduced_config("gemma2-2b", num_layers=2, d_model=d_model,
                              d_ff=4 * d_model)


def _phase(cfg=None):
    return CS.phase_roofline(torch.device("cpu"), "cpu", cfg or _cfg(), SEQ,
                             TRAIN_ARGV, power=None)


def test_roofline_phase_on_the_cpu(monkeypatch, capsys):
    _stand_ins(monkeypatch)
    rep = _phase()
    fwd = rep["forward"]
    # four norms a layer (gemma2's post norms) and the final one
    assert fwd["launches"] == {"A": 0, "B": 0, "C": 0, "D": 9, "E": 2}
    assert fwd["plain_flops_equal"]
    assert set(fwd["kernel_bytes"]) == {"kernel rmsnorm",
                                        "kernel flash_attention"}
    # the attention over whole blocks: a local (window 64) and a global
    # layer of two 512-blocks, 1 + 2 and 3 block pairs
    assert fwd["attention_pairs"] == {
        "lm_bounds": 2 * SEQ * (SEQ + 1) // 2,
        "visible": SEQ * (SEQ + 1) // 2 + (64 * 65 // 2 + (SEQ - 64) * 64),
        "blocks": 6 * 512 * 512}
    assert fwd["flops_by_op"]["dot"] == fwd["lm_bounds_ops"] + (
        fwd["attention_flops"]["blocks"] - fwd["attention_flops"]["lm_bounds"])
    assert abs(fwd["dot_vs_lm_bounds"]) <= CS.ROOFLINE_LM_RTOL
    assert fwd["terms"]["peak_flops"] == 989e12
    assert fwd["measured_over_bound"] > 0
    tr = rep["train"]
    assert tr["flops"] >= tr["train_step_flops"]
    assert 0.5 < tr["useful_flops_ratio"] < 1.0
    assert len(rep["dosc"]["energy"]) == len(rep["dosc"]["time"]) == 5
    assert rep["dosc"]["pods"] == 2 and rep["dosc"]["intra_pod_chips"] == 8
    assert "power" not in rep and "dominant" in rep["table"]
    assert "roofline forward" in capsys.readouterr().out


def test_an_uncredited_launch_fails_the_equal_flops_gate(monkeypatch):
    _stand_ins(monkeypatch, credit=False)
    with pytest.raises(CS.SmokeFailure,
                       match="no launch of flash_attention was credited"):
        _phase()


def test_the_lm_bounds_gate_bites_at_a_narrow_width(monkeypatch):
    """At d 128 the whole diagonal blocks put the dot flops 16 % above
    ``lm_bounds``: the explained equality holds, the 5 % gate fails."""
    _stand_ins(monkeypatch)
    with pytest.raises(CS.SmokeFailure, match=r"\+0\.1596 from lm_bounds"):
        _phase(_cfg(128))


def test_gemma2_full_size_arithmetic():
    """The full forward's attention pairs (26 layers, window 4096 on the
    13 local ones, 512-blocks) and where its dot flops land against
    ``lm_bounds``' operations: within the 5 % gate, by hand."""
    cfg = get_config("gemma2-2b")
    pairs = CS.attention_pairs(cfg, 8192)
    causal = 8192 * 8193 // 2
    local = 4096 * 4097 // 2 + 4096 * 4096
    assert pairs == {"lm_bounds": 26 * causal,
                     "visible": 13 * (causal + local),
                     "blocks": 13 * (136 + 108) * 512 * 512}
    d, h, kv, hd, ff, V = 2304, 8, 4, 256, 9216, 256000
    per_pair = 4 * hd * h
    matmuls = 8192 * 2 * (26 * (2 * d * h * hd + 2 * d * kv * hd
                                + 3 * d * ff) + d * V)
    lm_ops = matmuls + per_pair * pairs["lm_bounds"]
    dot = matmuls + per_pair * pairs["blocks"]
    assert abs(dot / lm_ops - 1) <= CS.ROOFLINE_LM_RTOL
    assert 4.9e13 < dot < 5.0e13


def test_power_draw_reads_the_median_of_the_later_readings(monkeypatch):
    readings = itertools.chain([100.0, 400.0, 410.0, 420.0],
                               itertools.repeat(430.0))
    monkeypatch.setattr(CS, "query_gpu", lambda q: f"{next(readings)} W")
    monkeypatch.setattr(CS.time, "sleep", lambda s: None)
    got = CS.power_draw(None, 0.05)
    assert got["readings"] >= 2 and got["runs"] == 0
    assert 400.0 <= got["w"] <= 430.0
