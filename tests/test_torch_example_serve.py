"""``examples/torch_quickstart.py`` and ``examples/torch_serve_batched.py``
with ``--device cpu`` against the reference examples on the same weights
(the JAX package's, through the bridge): the same prints (but wall and
latency readings), token-identical outputs a request and the same
completion order in each class, and each passes its own assertions."""

import pytest

from torch_examples import by_class, load, printed, run_reference, serve_with_jax_weights


@pytest.mark.parametrize("name", ["quickstart", "serve_batched"])
def test_example_matches_the_reference(name, monkeypatch, capsys):
    drains = serve_with_jax_weights(monkeypatch)
    ref, port = load(name), load(f"torch_{name}")
    want = printed(capsys, lambda: run_reference(ref, [], monkeypatch))
    got = printed(capsys, lambda: port.main(["--device", "cpu"]))
    assert got == want
    assert len(drains["jax"]) == len(drains["torch"]) == 1
    assert by_class(drains["torch"][0]) == by_class(drains["jax"][0])
    assert len(drains["torch"][0]) == {"quickstart": 4, "serve_batched": 9}[name]


def test_example_on_the_card_needs_a_card(monkeypatch):
    """``--device cuda`` (the default) without a card fails loudly."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        load("torch_quickstart").main([])
