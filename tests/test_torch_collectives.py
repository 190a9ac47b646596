"""The port's collective count (``repro_torch/roofline/collectives.py``, the
counterpart of ``repro/roofline/hlo_parse.py``) and the fused kernels'
meta ops (``kernels/fused/meta.py``), on a fake process group of 4 ranks
and meta tensors: nothing is allocated or sent.

* One ``Shard(0) -> Replicate`` redistribution of a known tensor is exactly
  one all-gather of its bytes; an in-place ``dist.all_reduce`` inside a
  ``local_map`` body is counted; the dict has the JAX parser's form and
  equals what ``hlo_parse.collective_bytes`` reads from the HLO of the same
  collectives.
* FLOPs are per rank: a DTensor product counts its local block, the
  shape-propagation ops DTensor runs on global fake tensors are left out.
* The meta branch of every fused wrapper is meta-only: on CPU tensors each
  returns its plain version's values, on meta operands the kernel's shapes
  and dtypes with no build and no launch, its products counted; a gradient
  through it runs its backward meta op, the backward's products counted.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.roofline import hlo_parse
from repro_torch import sfu
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import _build, fused, ops
from repro_torch.kernels.fused import meta
from repro_torch.roofline import collectives as C


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _meta_dtensor(mesh, local_shape, placements, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype, device="meta"), mesh,
                              placements, run_check=False)


def test_one_redistribution_is_one_all_gather_of_its_bytes(mesh):
    x = _meta_dtensor(mesh, (8, 16), [Shard(0), Replicate()])  # (16, 16) f32 whole
    with C.trace() as rec:
        y = x.redistribute(mesh, [Replicate(), Replicate()])
    assert tuple(y.shape) == (16, 16)
    assert C.collective_bytes(rec) == {"all-gather": 16 * 16 * 4, "total": 16 * 16 * 4,
                                       "count": 1}
    assert C.collective_counts(rec) == {"all-gather": 1}
    assert rec.flops == 0


def test_in_place_all_reduce_in_a_local_map_body_is_counted(mesh):
    group = mesh.get_group("model")

    def body(t):
        t = t.clone()
        dist.all_reduce(t, group=group)  # the in-place c10d op
        return t

    x = _meta_dtensor(mesh, (4, 6), [Shard(0), Shard(1)])
    f = local_map(body, out_placements=[Shard(0), Replicate()],
                  in_placements=([Shard(0), Shard(1)],), device_mesh=mesh)
    with C.trace() as rec:
        f(x)
    assert rec.ops["c10d::allreduce_"] == 1
    assert C.collective_bytes(rec) == {"all-reduce": 4 * 6 * 4, "total": 96, "count": 1}


def test_same_dict_as_the_hlo_parser_on_the_same_collectives(mesh):
    """An all-gather to f32[16,16] and an all-reduce of bf16[4,6] a rank:
    the port's dict equals ``hlo_parse.collective_bytes`` of the HLO lines
    XLA writes for them."""
    x = _meta_dtensor(mesh, (8, 16), [Shard(0), Replicate()])
    group = mesh.get_group("data")
    with C.trace() as rec:
        x.redistribute(mesh, [Replicate(), Replicate()])
        dist.all_reduce(torch.empty((4, 6), dtype=torch.bfloat16, device="meta"), group=group)
    hlo = ("%ag = f32[16,16]{1,0} all-gather(f32[8,16]{1,0} %x), dimensions={0}\n"
           "%ar = bf16[4,6]{1,0} all-reduce(bf16[4,6]{1,0} %y), to_apply=%add\n")
    assert C.collective_bytes(rec) == hlo_parse.collective_bytes(hlo)


@pytest.mark.parametrize("name,kind", [
    ("_c10d_functional::all_gather_into_tensor", "all-gather"),
    ("_c10d_functional::reduce_scatter_tensor", "reduce-scatter"),
    ("_c10d_functional::all_reduce", "all-reduce"),
    ("_c10d_functional::all_to_all_single", "all-to-all"),
    ("c10d::allreduce_", "all-reduce"),
    ("c10d::_allgather_base_", "all-gather"),
    ("c10d::_reduce_scatter_base_", "reduce-scatter"),
    ("c10d::alltoall_base_", "all-to-all"),
    ("c10d::send", "collective-permute"),
    ("_c10d_functional::wait_tensor", None),
    ("aten::all", None),
])
def test_collective_kinds(name, kind):
    assert C.collective_kind(name) == kind


def test_flops_are_the_ranks_local_products(mesh):
    """(8, 16) rows over "data" times (16, 32) columns over "model": each
    rank multiplies (4, 16) by (16, 16), forward and both gradients of an
    output gradient placed as the output; the global-shape product DTensor
    propagates on fake tensors is not counted."""
    x = _meta_dtensor(mesh, (4, 16), [Shard(0), Replicate()]).requires_grad_(True)
    w = _meta_dtensor(mesh, (16, 16), [Replicate(), Shard(1)]).requires_grad_(True)
    with C.trace() as rec:
        y = x @ w
        assert rec.flops == 2 * 4 * 16 * 16
        y.backward(_meta_dtensor(mesh, (4, 16), [Shard(0), Shard(1)]))
    assert rec.flops == 3 * 2 * 4 * 16 * 16
    assert C.op_histogram(rec) == {"mm": 3}


def test_op_histogram_counts_the_ports_custom_ops():
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((8, 16), device="meta")
    with C.trace() as rec:
        meta.glu(x, w, w)
        x @ w
    assert C.op_histogram(rec) == {"custom-call": 1, "mm": 1}
    assert rec.flops == 4 * 4 * 8 * 16 + 2 * 4 * 8 * 16


def test_attention_pairs():
    assert meta.attention_pairs(4, 4, False, None, 0) == 16
    assert meta.attention_pairs(4, 4, True, None, 0) == 10
    assert meta.attention_pairs(4, 4, True, 2, 0) == 7
    assert meta.attention_pairs(1, 9, True, None, 8) == 9
    # a brute-force count at a window and an offset
    S, T, w, off = 7, 12, 3, 5
    want = sum(1 for s in range(S) for t in range(T) if t <= off + s and off + s - t < w)
    assert meta.attention_pairs(S, T, True, w, off) == want


# ---------------------------------------------------------------------------
# the meta branch of the fused wrappers


def _tables():
    cfg = get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True)
    plan = sfu.plan_for(cfg)
    return (plan.fused_table(sfu.site_key(sfu.SITE_MLP, cfg.activation)),
            plan.fused_table(sfu.site_key(sfu.SITE_SOFTMAX, "exp")))


def _calls(act, exp):
    """name -> (call on operands, operand shapes and dtypes, the kernel's
    products on them)."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    return {
        "fused_glu": (lambda x, w, u: fused.fused_glu(x, w, u, table=act),
                      [((3, 5, 16), bf), ((16, 24), bf), ((16, 24), bf)], 4 * 15 * 16 * 24),
        "fused_moe_glu": (lambda x, w, u: fused.fused_moe_glu(x, w, u, table=act),
                          [((2, 5, 16), bf), ((2, 16, 24), bf), ((2, 16, 24), bf)],
                          4 * 10 * 16 * 24),
        "fused_linear": (lambda x, w, b: fused.fused_linear(x, w, b, table=act),
                         [((7, 16), bf), ((16, 24), bf), ((24,), bf)], 2 * 7 * 16 * 24),
        "fused_pwl_softmax": (lambda s: fused.fused_pwl_softmax(s, table=exp, causal=True),
                              [((2, 3, 8, 8), f32)], 0),
        "fused_flash_attention": (
            lambda q, k, v: fused.fused_flash_attention(q, k, v, table=exp, causal=True),
            [((2, 8, 4, 16), bf), ((2, 8, 2, 16), bf), ((2, 8, 2, 16), bf)],
            4 * 2 * 4 * 16 * 36),
        "paged_flash_decode": (
            lambda q, kp, vp, pt, n: fused.paged_flash_decode(q, kp, vp, pt, n, table=exp),
            [((2, 1, 4, 16), bf), ((2, 6, 8, 16), bf), ((2, 6, 8, 16), bf), ((2, 3), i32),
             ((2,), i32)], 4 * 2 * 4 * 16 * 3 * 8),
        "fused_rmsnorm": (lambda x, s: fused.fused_rmsnorm(x, s, table=act),
                          [((5, 16), bf), ((16,), f32)], 0),
        "pwl_activation": (lambda x: ops.pwl_activation(x, act), [((3, 7), bf)], 0),
    }


def _cpu_operands(specs, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for shape, dtype in specs:
        if dtype == torch.int32:
            out.append(torch.from_numpy(rng.integers(1, 6, shape).astype(np.int32)))
        else:
            out.append(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype))
    return out


@pytest.mark.parametrize("name", list(_calls(None, None)))
def test_meta_branch_shapes_dtypes_flops_and_no_launch(name, monkeypatch):
    """On meta operands: the CPU plain version's shapes and dtypes, no
    build (``_build.load`` raising) and no launch counted, the kernel's
    products counted."""
    act, exp = _tables()
    call, specs, flops = _calls(act, exp)[name]
    cpu = _cpu_operands(specs)
    want = call(*cpu)

    def no_build(*a, **k):
        raise AssertionError("a meta call built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    wrapper = getattr(ops if name == "pwl_activation" else fused, name)
    before = wrapper.launches
    with C.trace() as rec:
        got = call(*[torch.empty(s, dtype=d, device="meta") for s, d in specs])
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert wrapper.launches == before
    assert rec.flops == flops
    assert C.op_histogram(rec).get("custom-call") == 1


# name -> (the backward meta op, the kernels' products of forward and
# backward: a GLU's 4MKN again in its backward's recompute, then the
# 4MKN of dx and of the two weight gradients; a linear's 2MKN four times;
# the flash attention's two products forward and five backward over the
# masked pairs; the softmax and the RMSNorm do none)
_BWD = {
    "fused_glu": ("glu_bwd", 16 * 15 * 16 * 24),
    "fused_moe_glu": ("glu_bwd", 16 * 10 * 16 * 24),
    "fused_linear": ("linear_bwd", 8 * 7 * 16 * 24),
    "fused_pwl_softmax": ("row_softmax_bwd", 0),
    "fused_flash_attention": ("flash_bwd", 14 * 2 * 4 * 16 * 36),
    "fused_rmsnorm": ("rmsnorm_bwd", 0),
}


def _grads(call, operands):
    out = call(*operands)
    return torch.autograd.grad(out, operands, grad_outputs=torch.ones_like(out))


@pytest.mark.parametrize("name", list(_BWD))
def test_meta_backward_shapes_dtypes_flops_and_no_launch(name, monkeypatch):
    """A gradient through a wrapper on meta operands runs its backward meta
    op: the CPU plain version's gradient shapes and dtypes, no build and no
    backward launch, the forward's and the backward's products counted."""
    act, exp = _tables()
    call, specs, _ = _calls(act, exp)[name]
    op, flops = _BWD[name]
    want = _grads(call, [t.requires_grad_(True) for t in _cpu_operands(specs)])

    def no_build(*a, **k):
        raise AssertionError("a meta call built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    wrapper = getattr(fused, name)
    before = wrapper.bwd_launches
    with C.trace() as rec:
        got = _grads(call, [torch.empty(s, dtype=d, device="meta", requires_grad=True)
                            for s, d in specs])
    assert [(g.device.type, tuple(g.shape), g.dtype) for g in got] == \
        [("meta", tuple(w.shape), w.dtype) for w in want]
    assert wrapper.bwd_launches == before
    assert rec.ops[f"repro_torch::{op}"] == 1
    assert rec.flops == flops


def _plain(name, act, exp):
    """Each wrapper's plain version, called directly on the same operands."""
    from repro_torch.kernels import pwl_act
    from repro_torch.kernels.fused import decoding, softmax

    pa = fused.epilogue.device_operands(act, None, "cpu")
    pe = fused.epilogue.device_operands(exp, None, "cpu")

    def glu(x, w, u):
        x2 = x if w.dim() == 3 else x.reshape(-1, x.shape[-1])
        return fused.fused_glu_plain(x2, w, u, *pa).reshape(*x.shape[:-1], w.shape[-1])

    def row_softmax(s):
        x2 = s.reshape(-1, s.shape[-1])
        mask = softmax._plain_mask(x2, None, s.shape[-2], True, None)
        return fused.fused_pwl_softmax_plain(x2, mask, *pe).reshape(s.shape)

    def paged(q, kp, vp, pt, n):
        pps = min(max(1, decoding.DEFAULT_SPLIT_KEYS // kp.shape[2]), pt.shape[1])
        return fused.paged_flash_decode_plain(q, kp, vp, pt, n, *pe, pps)

    return {
        "fused_glu": glu,
        "fused_moe_glu": glu,
        "fused_linear": lambda x, w, b: fused.fused_linear_plain(x, w, b, *pa),
        "fused_pwl_softmax": row_softmax,
        "fused_flash_attention": lambda q, k, v: fused.fused_flash_attention_plain(
            q, k, v, *pe, causal=True, window=None, q_offset=0, kv_valid_len=None)[0],
        "paged_flash_decode": paged,
        "fused_rmsnorm": lambda x, s: fused.fused_rmsnorm_plain(x, s, *pa, 1e-6),
        "pwl_activation": lambda x: pwl_act.pwl_nonuniform_plain(x, *pa[1]),
    }[name]


@pytest.mark.parametrize("name", list(_calls(None, None)))
def test_cpu_operands_still_take_the_plain_version(name):
    """The meta branch changes nothing on the CPU: each wrapper returns its
    plain version's values, bitwise."""
    act, exp = _tables()
    call, specs, _ = _calls(act, exp)[name]
    cpu = _cpu_operands(specs, seed=1)
    got = call(*cpu)
    assert got.device.type == "cpu"
    assert torch.equal(got, _plain(name, act, exp)(*cpu))


def test_meta_ops_refuse_real_tensors():
    x = torch.ones(2, 2)
    with pytest.raises(RuntimeError, match="meta tensors only"):
        meta.glu(x, x, x)
