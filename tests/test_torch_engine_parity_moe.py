"""Port parity: a continuous-batching session of the torch
``PagedServingEngine`` gives the JAX ``PagedServingEngine``'s greedy tokens
on the same requests and the same (converted) parameters, in float32 on the
reduced olmoe-1b-7b config under the fused plan (the ``moe.expert:silu``
site on the per-expert GLU).  Every model call routes with its own
capacity: a prefill over its padded bucket, a decode step over every slot,
idle ones included, so both engines must make the same calls for the same
tokens.  Kept in a file of its own: the JAX engine compiles its
prefill/decode programs, which dominates the time of this file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401
from repro.configs import get_reduced_config
from repro.models import Model as JModel
from repro.serving import GenRequest as JGenRequest
from repro.serving import PagedServingEngine as JPagedServingEngine
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import GenRequest, PagedServingEngine


def test_session_tokens_equal_jax_engine():
    jcfg = dataclasses.replace(get_reduced_config("olmoe-1b-7b"), act_impl="fused",
                               dtype=jnp.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = t_get_reduced_config("olmoe-1b-7b", act_impl="fused", dtype=torch.float32)
    tmodel = Model(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")

    rng = np.random.default_rng(0)
    specs = [("a", rng.integers(1, 500, size=11).tolist(), 4),
             ("b", rng.integers(1, 500, size=27).tolist(), 6),
             ("c", rng.integers(1, 500, size=5).tolist(), 5)]
    jeng = JPagedServingEngine(jmodel, jparams, max_slots=2, page_size=16, max_context=64)
    want = {r.request_id: list(r.tokens)
            for r in jeng.run([JGenRequest(i, p, n) for i, p, n in specs])}
    teng = PagedServingEngine(tmodel, tparams, max_slots=2, page_size=16, max_context=64)
    got = {r.request_id: list(r.tokens)
           for r in teng.run([GenRequest(i, p, n) for i, p, n in specs])}
    assert got == want
    assert teng.decode_steps == jeng.decode_steps and teng.prefills == len(specs)
    assert teng.sched.allocator.num_free == teng.sched.allocator.num_pages - 1
