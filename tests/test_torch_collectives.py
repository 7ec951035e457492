"""The port's collectives against the JAX package's numbers on the CPU:
``quantize_int8`` / ``dequantize_int8`` bit for bit; then four ranks
(subprocesses over gloo, as in ``test_torch_sharding.py``): the int8
error-feedback reduction over the 'pod' dim of a (pod=2, data=2) mesh
equals the mean of JAX's per-rank dequantized values, with JAX's residual,
both exactly (two f32 summands); ``ring_ag_matmul`` on groups of 1, 2 and 4
ranks equals ``x @ w`` (f32, atol = rtol = 1e-5: the chunks' products
summed in ring order)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import collectives as JCOL
from repro_torch.parallel import collectives as COL
from test_torch_sharding import run_ranks

M, K, N = 8, 16, 12  # the ring's x [M, K] and w [K, N]


def _grads(rank):
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.standard_normal((6, 5)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal((7,)) * 3.0).astype(np.float32)}


def _ring_inputs():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _errs(rank):
    rng = np.random.default_rng(200 + rank)
    return {"a": (rng.standard_normal((6, 5)) * 1e-3).astype(np.float32),
            "b": (rng.standard_normal((7,)) * 1e-2).astype(np.float32)}


@pytest.mark.parametrize("shape,scale", [((64,), 1.0), ((8, 8), 1e-3), ((3, 5, 7), 50.0),
                                         ((1,), 0.0)])
def test_quantize_int8_is_bit_exact(shape, scale):
    x = (np.random.default_rng(7).standard_normal(shape) * scale).astype(np.float32)
    q, s = COL.quantize_int8(torch.from_numpy(x))
    jq, js = JCOL.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == tuple(js.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(COL.dequantize_int8(q, s).numpy(),
                                  np.asarray(JCOL.dequantize_int8(jq, js)))


def test_cross_pod_reduce_without_pod_returns_its_inputs():
    g, e = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    out, err = COL.cross_pod_grad_reduce(g, e, SimpleNamespace(mesh_dim_names=("data", "model")))
    assert out is g and err is e


_RANKS = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.parallel import collectives as COL

res = {}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
g, e, x, w = torch.load(os.path.join(OUT, f"in{RANK}.pt"))
res["pod"] = COL.cross_pod_grad_reduce(g, e, mesh)
K = w.shape[0]
groups = {4: None, 2: dist.new_subgroups(2)[0], 1: dist.new_subgroups(1)[0]}
for n, group in groups.items():
    idx, k = dist.get_rank(group), K // n
    res[f"ring{n}"] = COL.ring_ag_matmul(x, w[idx * k:(idx + 1) * k], group)
torch.save(res, os.path.join(OUT, f"rank{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    x, w = _ring_inputs()
    for r in range(4):
        torch.save(({k: torch.from_numpy(v) for k, v in _grads(r).items()},
                    {k: torch.from_numpy(v) for k, v in _errs(r).items()},
                    torch.from_numpy(x), torch.from_numpy(w)), out / f"in{r}.pt")
    run_ranks(_RANKS, 4, out)
    return [torch.load(out / f"rank{r}.pt") for r in range(4)]


def test_compressed_psum_over_pods_matches_jax(four_ranks):
    # rank = pod * 2 + data: the pod pairs are (0, 2) and (1, 3)
    for rank, res in enumerate(four_ranks):
        out, err = res["pod"]
        peer = rank ^ 2
        for k in ("a", "b"):
            deq = {}
            for r in (rank, peer):
                g32 = jnp.asarray(_grads(r)[k]) + jnp.asarray(_errs(r)[k])
                deq[r] = JCOL.dequantize_int8(*JCOL.quantize_int8(g32))
                if r == rank:
                    want_err = g32 - deq[r]
            want = (deq[min(rank, peer)] + deq[max(rank, peer)]) / 2.0
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(want))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(want_err))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_ag_matmul_equals_the_product(four_ranks, n):
    x, w = _ring_inputs()
    for res in four_ranks:
        np.testing.assert_allclose(res[f"ring{n}"].numpy(), x @ w, atol=1e-5, rtol=1e-5)
