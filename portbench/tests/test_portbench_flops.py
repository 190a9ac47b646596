"""The frozen counting at hand-counted shapes: ``chip_smoke.py``'s printed
bounds (PERF.md's table of kernels) and the cells' own shapes."""
import json

import pytest

from portbench import flops, reference
from portbench.tests import tiny


def _cfg(name):
    return json.loads((tiny.PORTBENCH / "configs" / f"{name}.json").read_text())


def test_chip_smoke_bounds():
    # olmo-1b's GLU at M = 4096 (2·2·4096·2048·8192 FLOPs): 277.94 µs
    assert flops.glu_fwd(1, 4096, 2048, 8192) * 1e6 == pytest.approx(277.94, abs=0.01)
    assert flops.glu_bwd(1, 4096, 2048, 8192) * 1e6 == pytest.approx(277.94, abs=0.01)
    # olmoe's decode MoE GLU, E = 64, C = 1: the experts' weights, 160.4 µs of bytes
    assert flops.glu_fwd(64, 1, 2048, 1024) * 1e6 == pytest.approx(160.4, abs=0.05)
    # flash at S = T = 4096, 12 heads of 64, causal: 26.1 µs forward, 65.2 backward
    assert flops.flash_fwd(1, 12, 4096, 4096, 64) * 1e6 == pytest.approx(26.1, abs=0.05)
    assert flops.flash_bwd(1, 12, 4096, 4096, 64) * 1e6 == pytest.approx(65.2, abs=0.05)


def test_cell_shapes():
    # train-2k: M = 8·2048 = 16384, K = 2048, N = 8192: 4·M·K·N FLOPs
    assert flops.glu_fwd(1, 16384, 2048, 8192) == pytest.approx(4 * 16384 * 2048 * 8192 / 989e12)
    # flash at B = 8, 16 heads of 128, S = T = 2048, causal: 4·dh FLOPs a kept
    # pair, S·(S + 1)/2 pairs a head
    assert flops.flash_fwd(8, 16, 2048, 2048, 128) == pytest.approx(
        4 * 128 * 8 * 16 * 2048 * 2049 / 2 / 989e12)


def test_model_flops():
    olmoe, olmo = _cfg("olmoe-1b-7b"), _cfg("olmo-1b")
    fam = reference.family(olmo)
    assert reference.family(olmoe) is fam
    # 16 layers of attention (4·2048²) and 8 active experts (8·3·2048·1024)
    # with the router (2048·64), and the unembedding (2048·50304)
    assert fam.active_params(olmoe) == 16 * (4 * 2048**2 + 8 * 3 * 2048 * 1024 + 2048 * 64) \
        + 2048 * 50304
    assert fam.active_params(olmo) == 16 * (4 * 2048**2 + 3 * 2048 * 8192) + 2048 * 50304
    n = fam.active_params(olmo)
    assert fam.train_flops_token(olmo, 2048) == 6 * n + 6 * 16 * 2048 * 2048
    one = fam.request_flops(olmoe, 100, 1)
    assert one == fam.prefill_flops(olmoe, 100)
    assert fam.request_flops(olmoe, 100, 3) == pytest.approx(
        one + fam.decode_flops(olmoe, 101) + fam.decode_flops(olmoe, 102))
