"""The port's roofline, energy and partition-advisor modules
(``repro_torch.core.{roofline,tpu_energy,dosc}``) against the
reference's: the cases of the reference's ``tests/test_hlo_analysis.py``
(``TestRoofline``, ``TestTPUEnergy``, ``TestDOSCAdvisor``), computed by
both packages on the same counts under ``TPU_V5E`` and equal exactly
(plain Python floats); then the H100 spec (``constants.H100_SXM``) and
the one deviation from the reference, ``roofline_fraction`` under a chip
other than ``TPU_V5E``.  The reference runs in one child
(``tests/_jax_reference.py``: ``repro.core`` imports need its shim)."""

import dataclasses

import pytest
import torch

from _jax_reference import roofline_cases, run, sample_hlo
from repro_torch.core import dosc, hlo_analysis as H, roofline, tpu_energy
from repro_torch.core.constants import H100_SXM, TPU_V5E, TPUChipSpec

CHIPS = {"tpu-v5e": TPU_V5E, "h100-sxm": H100_SXM}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return run("roofline")


@pytest.fixture(scope="module")
def port():
    return roofline_cases(H, roofline, tpu_energy, dosc, TPU_V5E)


@pytest.mark.parametrize("key", [
    "terms", "spread", "table", "split16", "split4", "energy", "energy_t",
    "advise_1_time", "advise_1_energy", "advise_2_time", "advise_2_energy",
    "plans", "grad_reduce"])
def test_equals_the_reference_exactly_under_tpu_v5e(ref, port, key):
    got = port[key]
    if key in ("terms", "spread"):
        # the one key the port's to_dict adds (listed in its docstring)
        got = dict(got)
        assert got.pop("peak_flops") == TPU_V5E.peak_flops_bf16
    assert got == ref[key]


def _terms(chip):
    s = H.parse_collectives(sample_hlo())
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    return roofline.build_terms("testarch", "train_4k", "16x16", 256, cost,
                                s, model_flops_global=200e12, chip=chip)


@pytest.mark.parametrize("chip", CHIPS)
def test_terms_seconds(chip):
    spec = CHIPS[chip]
    t = _terms(spec)
    assert t.t_compute == pytest.approx(1e12 / spec.peak_flops_bf16)
    assert t.t_memory == pytest.approx(1e9 / spec.hbm_bandwidth)
    assert t.t_collective == pytest.approx(
        t.collective_wire_bytes / spec.ici_link_bandwidth)
    assert t.t_collective > 0


@pytest.mark.parametrize("chip", CHIPS)
def test_dominant_bounds_and_useful_ratio(chip):
    t = _terms(CHIPS[chip])
    assert t.dominant in ("compute", "memory", "collective")
    assert t.t_bound == max(t.t_compute, t.t_memory, t.t_collective)
    assert t.t_serial >= t.t_bound
    assert t.useful_flops_ratio == pytest.approx(200e12 / (1e12 * 256))
    tbl = roofline.format_table([t])
    assert "testarch" in tbl and "dominant" in tbl


def test_roofline_fraction_deviation_under_the_h100():
    """The deviation, stated: the reference's ``roofline_fraction``
    divides by ``TPU_V5E``'s peak whatever chip ``build_terms`` got
    (``src/repro/core/roofline.py:73-75``); the port divides by the
    chip's own.  Under ``TPU_V5E`` the two are one number (the parity
    cases above); under the H100 the port's reading is the reference
    formula's times 197/989."""
    t = _terms(H100_SXM)
    assert t.peak_flops == H100_SXM.peak_flops_bf16 == 989e12
    want = 200e12 / (256 * 989e12 * t.t_bound)
    assert t.roofline_fraction == pytest.approx(want, rel=1e-15)
    reference_formula = 200e12 / (256 * TPU_V5E.peak_flops_bf16
                                  * t.t_bound)
    assert t.roofline_fraction == pytest.approx(
        reference_formula * 197e12 / 989e12, rel=1e-12)
    assert t.to_dict()["peak_flops"] == 989e12
    v5e = _terms(TPU_V5E)
    assert v5e.roofline_fraction == 200e12 / (
        256 * TPU_V5E.peak_flops_bf16 * v5e.t_bound)


@pytest.mark.parametrize("chip", CHIPS)
def test_tier_split_and_step_energy(chip):
    spec = CHIPS[chip]
    s = H.parse_collectives(sample_hlo())
    ici, dcn = tpu_energy.split_tiers(s, intra_pod_chips=16)
    assert dcn == pytest.approx(
        next(o for o in s.ops if o.group_size == 32).wire_bytes)
    assert ici > 0
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    t = roofline.build_terms("a", "s", "m", 256, cost, s, 2e14, chip=spec)
    e = tpu_energy.step_energy(t, s, intra_pod_chips=256, chip=spec)
    assert e.total == pytest.approx(sum(e.breakdown().values()))
    assert e.avg_power_w > 0
    assert e.e_compute == 1e12 * spec.e_per_flop
    assert e.e_idle == pytest.approx(spec.idle_power * t.t_bound)
    later = tpu_energy.step_energy(t, s, 256, t_step=2 * t.t_bound,
                                   chip=spec)
    assert later.e_idle == pytest.approx(2 * e.e_idle)
    assert tpu_energy.system_power_w(e, 8) == 8 * e.avg_power_w


@pytest.mark.parametrize("chip", CHIPS)
def test_dosc_advisor_properties(chip):
    """The reference's four advisor properties, under each chip."""
    spec = CHIPS[chip]
    ranked = dosc.advise(grad_elems_per_chip=50e6, pods=2,
                         intra_pod_chips=256, objective="time", chip=spec)
    flat = next(c for c in ranked if c.plan.name == "flat-ar-f32")
    hier = next(c for c in ranked if c.plan.name == "hier-f32")
    assert hier.t_comm_s < flat.t_comm_s
    ranked = dosc.advise(grad_elems_per_chip=50e6, pods=2,
                         intra_pod_chips=256, chip=spec)
    f32 = next(c for c in ranked if c.plan.name == "hier-f32")
    int8 = next(c for c in ranked if c.plan.name == "hier-int8-ef")
    assert int8.dcn_bytes == pytest.approx(f32.dcn_bytes / 4)
    ranked = dosc.advise(grad_elems_per_chip=50e6, pods=1,
                         intra_pod_chips=256, chip=spec)
    assert all(c.dcn_bytes == 0 for c in ranked if c.plan.hierarchical)
    ranked = dosc.advise(grad_elems_per_chip=50e6, pods=2,
                         intra_pod_chips=256, objective="energy", chip=spec)
    assert ranked[0].plan.dcn_dtype_bytes <= 2


def test_h100_spec_carries_no_tpu_constant():
    """Every field of the H100 spec is its own: the published rates, the
    derived energies and the card's idle reading; none is ``TPU_V5E``'s
    (nor the dataclass's TPU default)."""
    defaults = TPUChipSpec()
    for f in dataclasses.fields(TPUChipSpec):
        got = getattr(H100_SXM, f.name)
        assert got != getattr(TPU_V5E, f.name), f.name
        assert got != getattr(defaults, f.name), f.name
        if f.name != "name":
            assert got > 0, f.name
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bandwidth,
            H100_SXM.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert H100_SXM.ici_link_bandwidth == 900e9 / 2
    assert H100_SXM.dcn_bandwidth == 400e9 / 8
