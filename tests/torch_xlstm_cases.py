"""Inputs of the xLSTM tests at smoke size (4 heads of 16), and the check
that h of the chunkwise mLSTM forward (the kernel on the card, its plain
torch mirror on the CPU) is held to at gates of +-30, row by row; run as
a script, the readings that check's factor was set from. numpy and torch
only, so the card's tests take the CPU tests' inputs from here.

At gates of +-30 h is ill-conditioned: m reaches 30, so exp(-m) no longer
floors the denominator max(|n . q|, exp(-m)), and n . q can cancel to a
small fraction of its terms, so that one row's h dwarfs the rest. There
every float32 order of the sums is far from float64, the plain loop's
too, by more than 1e-4 of the whole tensor. So h is held, row by row, to
the plain loop run in float64: where the float32 plain loop is within
``REL`` of the row, within ``REL`` of it too; on any other row (an
ill-conditioned one) within ``FACTOR`` times the float32 plain loop's own
error there. ``FACTOR`` lies between what the right orders reach on the
ill-conditioned rows and what known-wrong variants reach:

    PYTHONPATH=src python tests/torch_xlstm_cases.py         # the CPU mirror and its variants
    PYTHONPATH=src python tests/torch_xlstm_cases.py --card  # the forward kernel, on the card
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import xlstm_scan as xs

B, H, D = 2, 4, 16
L = xs.CHECKPOINT_EVERY  # 32, the mLSTM kernel's chunk too (on the card: xs.kernel_chunk())
MLSTM_SEQS = [1, L - 1, L, L + 1, 3 * L + 5]
# the extreme cases whose h has ill-conditioned rows
EXTREME_CASES = [(L + 1, False), (3 * L + 5, False), (3 * L + 5, True)]
REL = 1e-4
FACTOR = 8.0


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def mlstm_np(rng, S, carried):
    q, k, v = (rand(rng, B, H, S, D) for _ in range(3))
    i_pre, f_pre = rand(rng, B, H, S), rand(rng, B, H, S) + 1.0
    if carried:
        state = (rand(rng, B, H, D, D, scale=0.3), rand(rng, B, H, D, scale=0.3),
                 rand(rng, B, H))
    else:
        state = (np.zeros((B, H, D, D), np.float32), np.zeros((B, H, D), np.float32),
                 np.full((B, H), -np.inf, np.float32))
    return (q, k, v, i_pre, f_pre), state


def gates_np(rng, S, extreme):
    """i_pre and f_pre: normal, or a fifth of each at the extremes, log_i
    +-30 and f_pre -30 (the forget gate shut) or +30 (wide open)."""
    i_pre, f_pre = rand(rng, B, H, S), rand(rng, B, H, S) + 1.0
    if extreme:
        u, w = rng.random((B, H, S)), rng.random((B, H, S))
        i_pre = np.where(u < 0.1, 30.0, np.where(u > 0.9, -30.0, i_pre)).astype(np.float32)
        f_pre = np.where(w < 0.1, -30.0, np.where(w > 0.9, 30.0, f_pre)).astype(np.float32)
    return i_pre, f_pre


def mlstm_case(S, carried, extreme):
    """The float32 inputs (q, k / sqrt(D), v, log_i, log_f, C, n, m) of the
    chunkwise forward and the numpy inputs of the reference's
    ``mlstm_scan``."""
    rng = np.random.default_rng(S * 4 + carried * 2 + extreme + 500)
    (q, k, v, _, _), state = mlstm_np(rng, S, carried)
    i_pre, f_pre = gates_np(rng, S, extreme)
    args = [torch.from_numpy(a) for a in (q, k / math.sqrt(D), v, i_pre,
                                          F.logsigmoid(torch.from_numpy(f_pre)).numpy(), *state)]
    return args, (q, k, v, i_pre, f_pre, *state)


def extreme_case(S, carried):
    """An extreme case's inputs and ``ref_mlstm_fwd_saved`` on them."""
    args, _ = mlstm_case(S, carried, True)
    return args, ref.ref_mlstm_fwd_saved(*args, L)


def rows(args, h32, plain_h32):
    """Per row of h: the error of ``h32`` and of the float32 plain loop's
    ``plain_h32`` against the plain loop run in float64 on ``args`` (q, k, v,
    log_i, log_f, C, n, m), and the row's norm."""
    C, n, m = (a.double() for a in args[5:])
    hs = []
    for t in range(args[0].shape[2]):
        C, n, m, h, _ = ref.mlstm_step(C, n, m, *(a[:, :, t].double() for a in args[:5]))
        hs.append(h)
    exact = torch.stack(hs, dim=2)
    return ((h32.double() - exact).norm(dim=-1), (plain_h32.double() - exact).norm(dim=-1),
            exact.norm(dim=-1))


def check_rows(args, h32, plain_h32) -> int:
    """Holds ``h32`` to the rule above; returns the number of ill-conditioned
    rows, those held to ``FACTOR`` times the plain loop's own error."""
    err, own, row = rows(args, h32, plain_h32)
    loose = own > REL * row
    assert (err[~loose] <= REL * row[~loose]).all(), float((err / row)[~loose].max())
    assert (err[loose] <= FACTOR * own[loose]).all(), float((err / own)[loose].max())
    return int(loose.sum())


def readings(args, h32, plain_h32) -> tuple[int, float, float]:
    """(ill-conditioned rows, the largest err / own on them, the largest
    err / |row| on the others)."""
    err, own, row = rows(args, h32, plain_h32)
    loose = own > REL * row
    on = float((err / own)[loose].max()) if loose.any() else 0.0
    return int(loose.sum()), on, float((err / row)[~loose].max())


def _show(tag, n_rows, got):
    n, on, off = got
    print(f"{tag}: {n} of {n_rows} rows ill-conditioned, err/own there at most {on:.4g}, "
          f"err/|row| elsewhere at most {off:.4g}")


def _top(a, b):
    return a[0] + b[0], max(a[1], b[1]), max(a[2], b[2])


def _mirror():
    """The CPU mirror and its known-wrong variants at the extreme gates of
    ``test_torch_xlstm_scan.py``, every S and state."""
    import test_torch_xlstm_scan as T

    top = {}
    for S in MLSTM_SEQS:
        for carried in (False, True):
            args, plain = extreme_case(S, carried)
            for defect in (None, *T.DEFECTS):
                h32 = T.chunkwise_mlstm_fwd(*args, L, defect=defect)[4][4]
                got = readings(args, h32, plain[4][4])
                _show(f"S={S} carried={carried} {defect or 'mirror'}", h32[..., 0].numel(), got)
                top[defect] = _top(top.get(defect, (0, 0.0, 0.0)), got)
    for defect, got in top.items():
        _show(f"all cases, {defect or 'mirror'}", "all", got)


def _card():
    """The forward kernel in float32 on ``EXTREME_CASES`` (the plain loops
    on the CPU, as the CPU tests run them) and on the extreme cases of
    ``test_torch_cuda.py`` (xlstm-125m's heads; the plain loops on the card)."""
    import test_torch_cuda as TC

    name = torch.cuda.get_device_name(0)
    top = (0, 0.0, 0.0)
    for S, carried in EXTREME_CASES:
        args, plain = extreme_case(S, carried)
        h32 = xs.mlstm_fwd(*(a.cuda() for a in args), save=True)[4][4].cpu()
        got = readings(args, h32, plain[4][4])
        _show(f"kernel, B={B} H={H} d={D} S={S} carried={carried}", h32[..., 0].numel(), got)
        top = _top(top, got)
    _show(f"these cases, kernel ({name})", "all", top)
    top = (0, 0.0, 0.0)
    for B_, S, carried, d, extreme in TC.MLSTM_CASES:
        if extreme:
            args = TC._mlstm_inputs("cuda", "float32", B_, S, carried, d=d, extreme=True)
            h32 = xs.mlstm_fwd(*args, save=True)[4][4]
            plain = ref.ref_mlstm_fwd_saved(*args, xs.kernel_chunk())[4][4]
            got = readings(args, h32, plain)
            _show(f"kernel, B={B_} H=4 d={d} S={S} carried={carried}", h32[..., 0].numel(), got)
            top = _top(top, got)
    _show(f"these cases, kernel ({name})", "all", top)


if __name__ == "__main__":
    _card() if sys.argv[1:] == ["--card"] else _mirror()
