"""Port parity: a continuous-batching session of the torch
``PagedServingEngine`` under a plan of 129-segment uniform tables (128
breakpoints, past the CUDA kernels' shared-memory build) at the ``mlp`` and
``attn.softmax`` sites, both fused, gives the JAX engine's greedy tokens on
the same requests and (converted) parameters, in float32 on the reduced
repro-100m config.  Kept in a file of its own: the JAX engine compiles its
programs with the 128-breakpoint kernels unrolled, which dominates the time
of this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401
from repro import sfu as jsfu
from repro.configs import get_reduced_config
from repro.models import Model as JModel
from repro.serving import GenRequest as JGenRequest
from repro.serving import PagedServingEngine as JPagedServingEngine
from repro_torch import sfu
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import GenRequest, PagedServingEngine


def _wide_plan(package):
    spec = dict(n_segments=129, impl="fused", fit="uniform")
    return package.ActivationPlan(sites=(
        ("mlp:gelu_tanh", package.ApproxSpec(fn="gelu_tanh", **spec)),
        ("attn.softmax:exp", package.ApproxSpec(fn="exp", **spec))))


def test_engine_session_under_a_129_segment_plan_equals_jax():
    jplan = _wide_plan(jsfu)
    for _, spec in jplan.items():  # JAX builds a uniform table eagerly, not under its jit
        jsfu.get_store().get(spec)
    jcfg = dataclasses.replace(get_reduced_config("repro-100m"), act_plan=jplan,
                               dtype=jnp.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = t_get_reduced_config("repro-100m", act_plan=_wide_plan(sfu), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(0)
    # prompts in one prefill bucket, contexts within one page: one prefill
    # and one decode program for JAX to compile (its 128-breakpoint kernels
    # unroll the table)
    specs = [("a", rng.integers(1, 500, size=11).tolist(), 5),
             ("b", rng.integers(1, 500, size=7).tolist(), 6),
             ("c", rng.integers(1, 500, size=5).tolist(), 4)]
    jeng = JPagedServingEngine(jmodel, jparams, max_slots=2, page_size=16, max_context=64)
    want = {r.request_id: list(r.tokens)
            for r in jeng.run([JGenRequest(i, p, n) for i, p, n in specs])}
    teng = PagedServingEngine(Model(tcfg, device="cpu"), tparams, max_slots=2, page_size=16,
                              max_context=64)
    got = {r.request_id: list(r.tokens)
           for r in teng.run([GenRequest(i, p, n) for i, p, n in specs])}
    assert got == want
    assert sfu.plan_for(tcfg).spec("mlp:gelu_tanh").n_breakpoints == 128
