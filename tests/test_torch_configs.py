"""The port's configs against the JAX package's: ``get_config`` gives the
same ``ModelConfig`` for all ten archs (full and smoke), and the smoke
engine of each of the six attention configs copied for the serve driver
(glm4-9b, phi3-mini, command-r, llama4-maverick, llava-next, musicgen) is
token-identical to the JAX engine, with the JAX weights carried over by
repro_torch.bridge (float32). The two SSM/hybrid archs are refused by both
packages' engines."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.serving.engine import Engine as JaxEngine
from repro.serving.paged_model import paged_forward as jax_paged_forward
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.serving.engine import Engine

ATTENTION = ["glm4_9b", "phi3_mini", "command_r_35b", "llama4_maverick", "llava_next",
             "musicgen_large"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_get_config_matches_jax(arch, smoke):
    assert ARCHS == JAX_ARCHS
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1_5b"])
def test_engine_rejects_ssm_archs(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(AssertionError):
        Engine(cfg, {}, device="cpu")
    with pytest.raises(AssertionError):
        JaxEngine(jax_config(arch, smoke=True), {})


@pytest.mark.parametrize("arch", ATTENTION)
def test_smoke_engine_matches_jax_engine(arch):
    """Four prompts on two lanes with device admission: the same tokens,
    completion order and step count as the JAX engine."""
    jcfg = jax_config(arch, smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    jfwd = jax.jit(lambda p, t, kp, vp, bt, sl:
                   jax_paged_forward(p, t, jcfg, kp, vp, bt, sl))
    kw = dict(max_batch=2, page_size=8, num_pages=16, window=2, max_seq=32,
              device_admission=True)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7]]
    jeng = JaxEngine(jcfg, jparams, forward_fn=jfwd, **kw)
    teng = Engine(get_config(arch, smoke=True), tparams, device="cpu", **kw)
    juids = jeng.submit_many(prompts, max_new_tokens=4)
    tuids = teng.submit_many(prompts, max_new_tokens=4)
    jdone, tdone = jeng.run_until_idle(max_steps=200), teng.run_until_idle(max_steps=200)
    assert tuids == juids and list(tdone) == list(jdone)
    assert [tdone[u].output for u in tuids] == [jdone[u].output for u in juids]
    assert teng.step_count == jeng.step_count
    assert set(tuids) <= set(tdone)
