"""The comparison that decides ``correct``.

After the window a sample of the requests that finished in it, drawn from
the seed, with the longest among them, goes to the plain reference: each
prompt with its served tokens, once. At the position before each served
token the reference's float32 logits give its best logit; the reading is
the widest gap by which a served token's logit lies below that best, over
every judged position. Greedy serving, so a sound program serves the
reference's best or a near tie of it.

The control (``calibrate.py``) reads, at the same positions of the same
prompts and tokens, the gap of the token that the reference computed in
float8 puts first.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def pick(finished: List[dict], seed: int, judge: dict) -> List[dict]:
    """The judged requests: the longest (prompt + served) of ``finished``,
    then others in an order drawn from the seed until there are
    ``min_requests`` and ``min_served`` served tokens, or ``max_requests``."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda r: r["uid"])
    longest = max(pool, key=lambda r: (len(r["prompt"]) + len(r["output"]), r["uid"]))
    order = np.random.default_rng([int(seed) % 2 ** 64, 4]).permutation(len(pool))
    out, served = [longest], len(longest["output"])
    for i in order:
        if len(out) >= judge["max_requests"] or (
                served >= judge["min_served"] and len(out) >= judge["min_requests"]):
            break
        if pool[i] is not longest:
            out.append(pool[i])
            served += len(pool[i]["output"])
    return out


def sequences(reqs: List[dict], cfg: dict, family, decode_capacity: int = 0) -> List[dict]:
    """The reference's inputs: prompt + served tokens but the last, logits
    from the prompt's last position on. Where the family has expert slots
    (its ``capacity``), the forward calls the server ran over these
    positions: the prompt as one prefill call, each served token but the
    last as a decode step at ``decode_capacity``."""
    seqs = []
    for r in reqs:
        toks = list(r["prompt"]) + list(r["output"][:-1])
        s = {"tokens": toks, "first": len(r["prompt"]) - 1}
        P = len(r["prompt"])
        cap = family.capacity(P, cfg)
        if cap:
            s["segments"] = [(0, P, cap)] + [
                (p, p + 1, decode_capacity) for p in range(P, len(toks))]
        seqs.append(s)
    return seqs


def _widest_gap(ref_logits: List[torch.Tensor], tokens: List[torch.Tensor]) -> float:
    return max(float((lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).max())
               for lg, t in zip(ref_logits, tokens))


def served_gap(ref_logits: List[torch.Tensor], reqs: List[dict]) -> float:
    """Widest gap of a served token's reference logit below the best."""
    return _widest_gap(ref_logits, [torch.as_tensor(r["output"], device=lg.device)
                                    for lg, r in zip(ref_logits, reqs)])


def control_gap(ref_logits: List[torch.Tensor], ctl_logits: List[torch.Tensor]) -> float:
    """Widest gap of the control's first token's reference logit below the
    best, at the same positions."""
    return _widest_gap(ref_logits, [cl.argmax(dim=-1) for cl in ctl_logits])


def logit_err(ref_logits: List[torch.Tensor], tops: List[tuple]) -> float:
    """The median, over the judged positions, of the largest gap between a
    side's logit and the reference's at that side's top entries (``tops``:
    (values, ids) [positions, k] a request)."""
    errs = torch.cat([(v - lg.gather(1, i)).abs().amax(dim=1)
                      for lg, (v, i) in zip(ref_logits, tops)])
    return float(errs.median())


def not_greedy(reqs: List[dict], tops: List[tuple]) -> int:
    """Served tokens that are not the program's own best logit (greedy
    serving serves it)."""
    bad = 0
    for r, (v, i) in zip(reqs, tops):
        tok = torch.as_tensor(r["output"], device=i.device)[:, None]
        hit = (i == tok)
        best = v[:, :1]
        bad += int((~(hit & (v == best))).all(dim=1).sum())
    return bad
