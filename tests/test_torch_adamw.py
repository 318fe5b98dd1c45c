"""The port's ``repro_torch.optim.adamw`` against the reference's
``repro.optim.adamw`` (run eagerly in a child, ``tests/_jax_reference.py``)
on the same numpy trees: ``cosine_lr``, ``clip_by_global_norm`` and a
run of ``apply`` from ``init``, dtypes included.

The update is float32 in both packages.  Each float32 operation is IEEE
in both, except the float32 cosine of the schedule, which XLA and torch
each approximate (they differ by one float32 ulp at some steps).  So the
learning rate is held within 4 float32 ulps relative (5e-7) plus 4 ulps
of the cosine (2**-21, absolute) scaled by ``cfg.lr`` (near the end of
the decay ``1 + cos`` cancels, and an ulp of the cosine is up to 1.4e-6
of the rate there), and the parameters it moves within 5e-7 relative;
the moments, the clip and the norm do not depend on it and are
bitwise."""

import numpy as np
import pytest
import torch

from _jax_reference import run
from repro_torch.optim import adamw

LR_ULPS = 5e-7      # 4 float32 ulps, relative
COS_ULPS = 2.0**-21  # 4 float32 ulps of the cosine, absolute (times lr)
_DT = {"float32": torch.float32, "float64": torch.float64,
       "bfloat16": torch.bfloat16}

LR_CASES = [
    (dict(lr=0.05, warmup_steps=0, total_steps=200, min_lr_ratio=0.02,
          weight_decay=0.0), list(range(0, 205))),
    (dict(), [0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 12000]),
    (dict(lr=1e-3, warmup_steps=7, total_steps=31, min_lr_ratio=0.5),
     list(range(0, 40))),
]


def _tree(seed, spec):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dt) in spec.items():
        v = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 1, size=shape)
        if dt == "bfloat16":     # values a bfloat16 holds exactly
            v = torch.tensor(v, dtype=torch.bfloat16).float().numpy()
        out[name] = (np.asarray(v, np.float64).tolist(), dt)
    return out


def _torch_tree(t):
    return {k: torch.tensor(np.asarray(v), dtype=_DT[dt])
            for k, (v, dt) in t.items()}


def _host(t):
    return {k: (v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy(), str(v.dtype).replace("torch.", ""))
            for k, v in t.items()}


SPEC = {"a": ((), "float64"), "b": ((3,), "float32"),
        "w": ((4, 5), "float32"), "h": ((6,), "bfloat16")}
CLIP_CASES = [(_tree(0, SPEC), 1.0), (_tree(1, SPEC), 1e3),
              (_tree(2, {"k": ((), "float64"), "j": ((), "float64")}), 1.0)]
APPLY_CASES = [
    # the knob optimizer's configuration on two float64 scalars
    (dict(lr=0.05, warmup_steps=0, total_steps=12, min_lr_ratio=0.02,
          weight_decay=0.0),
     _tree(3, {"detnet_fps": ((), "float64"), "camera_fps": ((), "float64")}),
     [_tree(10 + i, {"detnet_fps": ((), "float64"),
                     "camera_fps": ((), "float64")}) for i in range(12)]),
    # weight decay on the matrix only, bfloat16 moments, warmup
    (dict(lr=3e-3, warmup_steps=3, total_steps=10, moment_dtype="bfloat16"),
     _tree(4, SPEC), [_tree(20 + i, SPEC) for i in range(8)]),
]


@pytest.fixture(scope="module")
def ref():
    return run("adamw", lr=LR_CASES, clip=CLIP_CASES, apply=APPLY_CASES)


@pytest.mark.parametrize("case", range(len(LR_CASES)))
def test_cosine_lr_matches_reference(ref, case):
    cfg_kw, steps = LR_CASES[case]
    want, want_dt = ref["lr"][case]
    cfg = adamw.AdamWConfig(**cfg_kw)
    got = [adamw.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
           for s in steps]
    assert {str(v.dtype) for v in got} == {f"torch.{want_dt}"}
    np.testing.assert_allclose([float(v) for v in got], want,
                               rtol=LR_ULPS, atol=COS_ULPS * cfg.lr)


@pytest.mark.parametrize("case", range(len(CLIP_CASES)))
def test_clip_by_global_norm_matches_reference(ref, case):
    t, max_norm = CLIP_CASES[case]
    want, want_norm, norm_dt = ref["clip"][case]
    clipped, norm = adamw.clip_by_global_norm(_torch_tree(t), max_norm)
    assert str(norm.dtype) == f"torch.{norm_dt}"
    assert float(norm) == want_norm
    got = _host(clipped)
    for k, (v, dt) in want.items():
        assert got[k][1] == dt, k
        assert got[k][0].tobytes() == np.asarray(v, got[k][0].dtype) \
            .tobytes(), k


@pytest.mark.parametrize("case", range(len(APPLY_CASES)))
def test_apply_matches_reference(ref, case):
    cfg_kw, params, grads = APPLY_CASES[case]
    cfg = adamw.AdamWConfig(**cfg_kw)
    x = _torch_tree(params)
    st = adamw.init(cfg, x)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for k, m in st.mu.items():
        assert m.dtype == _DT[cfg.moment_dtype] and not m.any()
    for g, want in zip(grads, ref["apply"][case]):
        x, st, metrics = adamw.apply(cfg, x, _torch_tree(g), st)
        assert int(st.step) == want["step"]
        assert str(st.step.dtype) == f"torch.{want['step_dtype']}"
        assert float(metrics["grad_norm"]) == want["grad_norm"]
        np.testing.assert_allclose(float(metrics["lr"]), want["lr"],
                                   rtol=LR_ULPS, atol=COS_ULPS * cfg.lr)
        for key in ("mu", "nu"):
            got = _host(getattr(st, key))
            for k, (v, dt) in want[key].items():
                assert got[k][1] == dt, (key, k)
                assert got[k][0].tobytes() == np.asarray(
                    v, got[k][0].dtype).tobytes(), (key, k)
        got = _host(x)
        for k, (v, dt) in want["params"].items():
            assert got[k][1] == dt, k
            np.testing.assert_allclose(got[k][0], v, rtol=LR_ULPS, atol=0,
                                       err_msg=k)


def test_update_is_float32_for_float64_params():
    """A float64 parameter is rounded to float32, updated there and
    widened back: its value after a step is a float32 value."""
    cfg = adamw.AdamWConfig(lr=0.05, warmup_steps=0, total_steps=10,
                            weight_decay=0.0)
    x = {"k": torch.tensor(0.1, dtype=torch.float64)}
    x2, _, _ = adamw.apply(cfg, x, {"k": torch.tensor(1e-3,
                                                      dtype=torch.float64)},
                           adamw.init(cfg, x))
    assert x2["k"].dtype == torch.float64
    assert float(x2["k"]) == float(x2["k"].float())
    assert torch.get_default_dtype() == torch.float32
