"""``examples/torch_serve_replicated.py --device cpu`` against the
reference example on the same weights (the JAX package's, through the
bridge): a live resize to 2 replicas, cadence checkpoints, a crash and
``Fabric.restore`` in each package; the same prints (but wall), and the
restored session's drain token-identical, in the same per-class order.
The example asserts that no request is lost or served twice."""

from torch_examples import by_class, load, printed, run_reference, serve_with_jax_weights


def test_replicated_matches_the_reference(monkeypatch, capsys, tmp_path):
    drains = serve_with_jax_weights(monkeypatch)
    ref, port = load("serve_replicated"), load("torch_serve_replicated")
    want = printed(capsys, lambda: run_reference(
        ref, ["--ckpt-dir", str(tmp_path / "jax")], monkeypatch))
    got = printed(capsys, lambda: port.main(["--ckpt-dir", str(tmp_path / "torch"),
                                             "--device", "cpu"]))
    assert got == want
    assert "cadence checkpoint@step" in got
    assert by_class(drains["torch"][-1]) == by_class(drains["jax"][-1])
