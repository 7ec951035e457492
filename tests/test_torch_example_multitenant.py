"""``examples/torch_serve_multitenant.py --device cpu`` under each policy
against the reference example on the same weights (the JAX package's,
through the bridge): the same prints (but wall and latency readings), the
same admitted set, token-identical outputs and the same per-class
completion order, and each run passes the example's own assertions."""

import pytest

from torch_examples import by_class, load, printed, run_reference, serve_with_jax_weights


@pytest.mark.parametrize("policy", ["strict", "wfq", "fifo"])
def test_multitenant_matches_the_reference(policy, monkeypatch, capsys):
    drains = serve_with_jax_weights(monkeypatch)
    ref, port = load("serve_multitenant"), load("torch_serve_multitenant")
    want = printed(capsys, lambda: run_reference(ref, ["--policy", policy], monkeypatch))
    got = printed(capsys, lambda: port.main(["--policy", policy, "--device", "cpu"]))
    assert got == want
    assert by_class(drains["torch"][0]) == by_class(drains["jax"][0])
    order, _ = by_class(drains["torch"][0])
    assert set(order) == {"interactive", "batch", "background"}
