"""Port parity under the fused-softmax plan: a continuous-batching session
of the torch ``PagedServingEngine`` gives the JAX engine's greedy tokens when
``attn.softmax:exp`` is planned fused (reduced repro-100m, float32, the same
converted parameters and requests as ``test_torch_engine_parity.py``).  The
torch side runs the plain versions of the fused row softmax (prefill) and of
the split-KV paged decode; the JAX side runs its Pallas kernels in interpret
mode.  Kept in a file of its own: the JAX engine's compile dominates it.
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
from repro_torch import sfu
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.kernels import fused
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import GenRequest, PagedServingEngine


def test_session_tokens_equal_jax_engine_under_fused_softmax():
    jcfg = dataclasses.replace(get_reduced_config("repro-100m"), act_impl="fused",
                               pwl_softmax=True, dtype=jnp.float32)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = t_get_reduced_config("repro-100m", act_impl="fused", pwl_softmax=True,
                                dtype=torch.float32)
    assert sfu.plan_for(tcfg).spec("attn.softmax:exp").impl == "fused"
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
    assert teng.decode_steps == jeng.decode_steps
    # the CPU wrappers run their plain versions and count no launch
    assert fused.fused_pwl_softmax.launches == 0 and fused.paged_flash_decode.launches == 0
