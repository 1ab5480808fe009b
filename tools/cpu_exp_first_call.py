"""Count how often the first parallel ``torch.exp`` of a CPU process is off.

    python3 tools/cpu_exp_first_call.py [--procs 48] [--at-once 12] [--warm-up]

Starts ``--procs`` fresh processes, ``--at-once`` of them side by side (the
CPU load of a parallel test run). Each runs the port's ``blockwise_attention``
three times on the inputs of ``tests/test_torch_attention_moe.py``'s
``test_banded_matches_full`` with two torch threads, and reports whether the
first call's softmax weights (``exp`` of the shifted scores) differ from the
later calls', and by how much against a float64 ``exp``. With
``--warm-up`` each process first calls ``torch.exp`` once on 2**17 numbers,
as the port's CPU tests do. Prints one JSON line with the counts. CPU only;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, math, sys
import numpy as np, torch
torch.set_num_threads(2)
if sys.argv[1] == "1":
    torch.exp(torch.randn((1 << 17,), generator=torch.Generator().manual_seed(0)))
from repro_torch.models.attention import NEG_INF, _mask_bias
rng = np.random.default_rng(1)
q, k, v = (torch.as_tensor(rng.normal(size=(1, 512, 4, 16)).astype(np.float32))
           for _ in range(3))

def weights():
    # the first KV block of blockwise_attention: scores, mask, online max, exp
    qq = q.reshape(1, 512, 4, 1, 16) / math.sqrt(16)
    s = torch.einsum("bqkgd,bskd->bkgqs", qq, k[:, :64])
    s = s + _mask_bias(torch.arange(512), torch.arange(64), True, 0)
    m = torch.maximum(torch.full((1, 4, 1, 512), NEG_INF), s.amax(dim=-1))
    e = s - m[..., None]
    return e, torch.exp(e)

runs = [weights() for _ in range(3)]
err = [float((p.double() - torch.exp(e.double())).abs().max()) for e, p in runs]
print(json.dumps({"first_differs": not torch.equal(runs[0][1], runs[1][1]),
                  "abs_err": err}))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=48)
    ap.add_argument("--at-once", type=int, default=12)
    ap.add_argument("--warm-up", action="store_true")
    a = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    results = []
    for start in range(0, a.procs, a.at_once):
        batch = [subprocess.Popen(
            [sys.executable, "-c", CHILD, "1" if a.warm_up else "0"],
            stdout=subprocess.PIPE, text=True, env=env)
            for _ in range(min(a.at_once, a.procs - start))]
        for p in batch:
            out, _ = p.communicate()
            if p.returncode != 0:
                sys.exit(f"a child process failed ({p.returncode})")
            results.append(json.loads(out.strip().splitlines()[-1]))
    odd = [r for r in results if r["first_differs"]]
    print(json.dumps({
        "torch": __import__("torch").__version__, "warm_up": a.warm_up,
        "procs": len(results), "first_call_differs": len(odd),
        "first_call_max_abs_err": max((r["abs_err"][0] for r in odd),
                                      default=None),
        "later_calls_max_abs_err": max(max(r["abs_err"][1:])
                                       for r in results)}))


if __name__ == "__main__":
    main()
