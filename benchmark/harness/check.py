"""Whether what the timed path served is right.

After the window, a sample of the requests the program served (finished,
or in flight at the close with the tokens served so far), drawn from the
seed with the longest among them, goes to the model family's reference
(`benchmark/reference/<family>.py`, float32 on the device) with the
weights made again from the seed.  The reference runs once over each prompt
followed by its served tokens; at each served token's position the gap is
the reference's best logit less the served token's logit (0 where the
program chose the reference's own argmax).  `logit_gap` is the widest gap
over the sample; `length_errors` counts finished requests that served
another number of tokens than they asked for.

The control (`readings(..., control=True)`) reads the same positions under
the reference computed with fp8 products: the gap of the token that the
fp8 reference puts first ("control_gap"), judged by the same `judge` and
`passed` as the program's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Served = Tuple[List[int], List[int]]  # (prompt ids, served tokens)


def sample(done: Sequence[Served], rng, served_tokens: int, max_requests: int) -> List[Served]:
    """The longest served request (prompt + served), then others in the
    seed's order until `served_tokens` tokens or `max_requests` requests."""
    done = [d for d in done if d[1]]
    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: -(len(done[i][0]) + len(done[i][1])))
    picked = [order[0]]
    for i in rng.permutation(order[1:]).tolist():
        if len(picked) >= max_requests or sum(len(done[j][1]) for j in picked) >= served_tokens:
            break
        picked.append(i)
    return [done[i] for i in picked]


def readings(torch, family, dm, seed: int, device, reqs: Sequence[Served],
             control: bool = False) -> Dict[str, float]:
    """The widest gap of the served tokens ("logit_gap") and, with
    `control`, of the fp8 reference's own choices ("control_gap"), over
    `reqs`, and the number of tokens compared.  `family` is the model
    family's module, `dm` its dims of the configuration."""
    seqs = [list(p) + list(s[:-1]) for p, s in reqs]
    spans = [(len(p) - 1, len(p) - 1 + len(s)) for p, s in reqs]
    precisions = ("float32", "fp8") if control else ("float32",)
    out = family.reference(torch, dm, seed, device).logits(seqs, spans, precisions)
    res = {"tokens": sum(len(s) for _, s in reqs), "logit_gap": 0.0}
    if control:
        res["control_gap"] = 0.0
    for j, (_, s) in enumerate(reqs):
        ref = out["float32"][j]
        best = ref.max(dim=-1).values
        served = torch.as_tensor(list(s), device=ref.device)
        rows = torch.arange(len(s), device=ref.device)
        res["logit_gap"] = max(res["logit_gap"], float((best - ref[rows, served]).max()))
        if control:
            pick = out["fp8"][j].argmax(dim=-1)
            res["control_gap"] = max(res["control_gap"], float((best - ref[rows, pick]).max()))
    return res


def judge(ck: Dict, logit_gap: Optional[float], length_errors: int) -> Dict[str, Dict]:
    """Each compared number beside its limit: the cell's `check` gives the
    logit gap's; a served length has to be exact."""
    return {"logit_gap": {"value": logit_gap, "limit": ck.get("logit_gap_limit")},
            "length_errors": {"value": length_errors, "limit": 0}}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["limit"] is not None and c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
