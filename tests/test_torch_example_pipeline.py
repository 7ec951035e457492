"""``examples/torch_data_pipeline_demo.py --device cpu``: the demo passes
its phases (steady state, a stalled producer absorbed, exact resume), and
every batch it consumed is the reference's: the JAX package's
``synth_batch`` of that batch id, token for token, as the reference
demo's own batches are."""

import numpy as np

from repro.data.pipeline import synth_batch as jax_synth_batch
from torch_examples import load, run_reference


def _recording(mod, seen):
    """``mod.DataPipeline`` whose consumers record each batch they take."""
    base = mod.DataPipeline

    class Recorded(base):
        def __iter__(self):
            for b in super().__iter__():
                seen.append((b["batch_id"], b["tokens"].copy()))
                yield b

    mod.DataPipeline = Recorded


def test_pipeline_demo_batches_are_the_reference_s(monkeypatch, capsys):
    port, ref = load("torch_data_pipeline_demo"), load("data_pipeline_demo")
    got, want = [], []
    _recording(port, got)
    _recording(ref, want)
    port.main(["--device", "cpu"])
    assert "demo OK" in capsys.readouterr().out
    run_reference(ref, [], monkeypatch)
    assert "demo OK" in capsys.readouterr().out
    assert len(got) == len(want) == 36  # 20 + 15 batches, then 1 after the resume
    for seen in (got, want):
        ids = [bid for bid, _ in seen[:35]]
        assert len(set(ids)) == 35  # no batch taken twice before the checkpoint
        for bid, tokens in seen:
            np.testing.assert_array_equal(tokens, jax_synth_batch(0, bid, 4, 128, 32000)["tokens"])
