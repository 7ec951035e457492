"""The port's train driver (``python -m repro_torch.launch.train``) against
the JAX package's: the same option strings plus ``--device``, the same
print lines on a 4-step smoke run on the CPU, and ``--resume`` from
``--ckpt-dir`` continuing at the saved step."""

import argparse
import re
import sys

import numpy as np
import pytest

from repro.launch import train as jax_train
from repro_torch.launch import train


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX driver builds inside ``main``: caught at its
    ``parse_args`` call, before the driver does anything else."""
    got = []

    def catch(self, *a, **kw):
        got.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        jax_train.main()
    monkeypatch.undo()
    return got[0]


def _options(ap: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (a.default, a.type, a.nargs, a.const)
            for a in ap._actions if a.option_strings and a.dest != "help"}


def test_option_strings_are_the_jax_drivers_plus_device(monkeypatch):
    ref = _options(_jax_parser(monkeypatch))
    port = _options(train.build_parser())
    assert set(port) == set(ref) | {"--device"}
    assert {k: port[k] for k in ref} == ref
    assert port["--device"][0] == "cuda"
    assert train.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        train.build_parser().parse_args(["--device", "tpu"])


ARGV = ["--arch", "yi-6b", "--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
        "--producers", "1"]


def _shape(text: str) -> list:
    """The printed lines with every number replaced by N."""
    return [re.sub(r"\d[\d,]*(\.\d+)?", "N", line) for line in text.strip().splitlines()]


def _same_lines_as_jax(monkeypatch, capsys, argv: list) -> dict:
    """The port's driver on the CPU prints the JAX driver's lines, numbers
    aside, and the same first line (model name and parameter count)."""
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train.main()
    ref = capsys.readouterr().out
    out = train.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape(got) == _shape(ref) and len(_shape(got)) == 3
    assert got.splitlines()[0] == ref.splitlines()[0]  # same model, same count
    assert out["steps"] == 4 and len(out["losses"]) == len(out["step_seconds"]) == 4
    return out


def test_smoke_run_prints_the_jax_drivers_lines(monkeypatch, capsys):
    assert _same_lines_as_jax(monkeypatch, capsys, ARGV)["params"] == 139584


def test_xlstm_smoke_run_prints_the_jax_drivers_lines(monkeypatch, capsys):
    """The recurrent family through the same driver (mLSTM + sLSTM blocks)."""
    argv = ["--arch", "xlstm-125m"] + ARGV[2:]
    out = _same_lines_as_jax(monkeypatch, capsys, argv)
    assert out["params"] == 111296 and all(np.isfinite(out["losses"]))


def test_resume_continues_from_the_saved_step(tmp_path, capsys):
    argv = ARGV + ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(argv)
    capsys.readouterr()
    again = train.main(argv[:argv.index("--steps") + 1] + ["2"]
                       + argv[argv.index("--steps") + 2:] + ["--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and "[train] step 6 " in out
    assert first["steps"] == 4 and again["steps"] == 6 and len(again["losses"]) == 2
