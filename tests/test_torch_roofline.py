"""Port parity: the analytic roofline (``repro_torch.roofline.model``) and
the shape cells (``repro_torch.models.SHAPE_CELLS``) against the JAX
package's on the CPU.

* ``SHAPE_CELLS`` equals JAX's, cell for cell.
* ``active_params``, ``total_params``, ``model_flops_train``,
  ``model_flops_decode``, ``analytic_memory_traffic`` and
  ``analytic_peak_memory`` equal JAX's (rel 1e-12) for every port arch (the
  reduced config of the archs refused at full width) at every cell, on one
  device and on the (16, 16) and (2, 16, 16) meshes, at microbatches 1 and 4.
* ``RooflineReport``'s terms, bottleneck and ``mfu`` at the H100 constants
  (989e12 FLOP/s, 3.35e12 B/s, 450e9 B/s), against values by hand.
"""
import dataclasses

import pytest

import repro  # noqa: F401
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import SHAPE_CELLS as JAX_CELLS
from repro.roofline import model as jrf
from repro_torch import roofline as trf
from repro_torch.configs import ARCH_IDS, REDUCED_ONLY, get_config, get_reduced_config
from repro_torch.models import SHAPE_CELLS, ShapeCell

MESHES = ({}, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
ARCHS = [(a, False) for a in ARCH_IDS] + [(a, True) for a in REDUCED_ONLY]


def _configs(arch, reduced):
    if reduced:
        return get_reduced_config(arch), jax_reduced(arch)
    return get_config(arch), jax_config(arch)


def test_shape_cells_equal_jax():
    assert list(SHAPE_CELLS) == list(JAX_CELLS)
    for name, cell in SHAPE_CELLS.items():
        assert isinstance(cell, ShapeCell)
        assert dataclasses.asdict(cell) == dataclasses.asdict(JAX_CELLS[name])


def test_h100_constants():
    assert trf.PEAK_FLOPS == 989e12
    assert trf.HBM_BW == 3.35e12
    assert trf.NVLINK_BW == 450e9


@pytest.mark.parametrize("arch,reduced", ARCHS, ids=[a for a, _ in ARCHS])
def test_param_and_flop_counts_match_jax(arch, reduced):
    tc, jc = _configs(arch, reduced)
    pairs = [(trf.active_params(tc), jrf.active_params(jc)),
             (trf.total_params(tc), jrf.total_params(jc)),
             (trf.model_flops_train(tc, 4096), jrf.model_flops_train(jc, 4096))]
    for batch, cache_len in ((1, 1), (4, 48), (128, 32768), (1, 524288)):
        pairs.append((trf.model_flops_decode(tc, batch, cache_len),
                      jrf.model_flops_decode(jc, batch, cache_len)))
    for got, want in pairs:
        assert got > 0
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("arch,reduced", ARCHS, ids=[a for a, _ in ARCHS])
def test_memory_terms_match_jax(arch, reduced, cell):
    tc, jc = _configs(arch, reduced)
    tcell, jcell = SHAPE_CELLS[cell], JAX_CELLS[cell]
    for mesh in MESHES:
        got = trf.analytic_memory_traffic(tc, tcell, dict(mesh))
        want = jrf.analytic_memory_traffic(jc, jcell, dict(mesh))
        assert got > 0
        assert got == pytest.approx(want, rel=1e-12)
        for mb in (1, 4):
            got = trf.analytic_peak_memory(tc, tcell, dict(mesh), mb)
            want = jrf.analytic_peak_memory(jc, jcell, dict(mesh), mb)
            assert got > 0
            assert got == pytest.approx(want, rel=1e-12)


def test_report_terms_at_h100_peaks():
    r = trf.RooflineReport(
        name="t", chips=8,
        hlo_flops=989e12,         # exactly 1 s of bf16 tensor-core compute
        hlo_bytes=3.35e12 / 4,    # 0.25 s of HBM
        coll_bytes=450e9 / 2,     # 0.5 s of NVLink
        model_flops=989e12 * 8 * 0.5,
        peak_mem_bytes=8 * 2**30,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.25)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck == "compute"
    assert r.t_bound == pytest.approx(1.0)
    assert r.mfu == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    row = r.row()
    assert row["t_memory_ms"] == pytest.approx(250.0)
    assert row["peak_mem_gb"] == pytest.approx(8.0)

    mem = dataclasses.replace(r, hlo_flops=989e12 / 10, coll_bytes=0.0)
    assert mem.bottleneck == "memory"
    # model FLOPs over (chips x peak x the 0.25 s memory bound)
    assert mem.mfu == pytest.approx(989e12 * 8 * 0.5 / (8 * 989e12 * 0.25))
    coll = dataclasses.replace(r, coll_bytes=450e9 * 3)
    assert coll.bottleneck == "collective"
    assert coll.t_bound == pytest.approx(3.0)


def test_mfu_of_a_measured_step():
    """The share ``chip_smoke.py`` prints: repro-100m's model FLOPs of an
    8 x 512 step over the bf16 peak times a step time."""
    cfg = get_config("repro-100m")
    flops = trf.model_flops_train(cfg, 8 * 512)
    assert flops == pytest.approx(6 * trf.active_params(cfg) * 4096)
    step_s = 0.1
    mfu = flops / (trf.PEAK_FLOPS * step_s)
    assert 0 < mfu < 1
    assert mfu == pytest.approx(6 * trf.active_params(cfg) * 4096 / 98.9e12)
