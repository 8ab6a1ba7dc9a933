"""Find an open-loop serving cell's knee: its traffic at a list of rates.

    python3 portbench/sweep.py --workload mistral7b-chat --seed 7 \
        --seconds 30 --rates 2 3 4 5

One process, one replica: set-up and warm-up once, then at each rate the
cell's open loop for ``--seconds`` (load continuing, unmeasured, until the
measured requests finish). Prints one JSON line per rate: requests offered
and finished, time to first token (p50, p90) from each request's due
time, inter-token gaps (p50, p95), output tokens/s inside the window, and
how late the generator ran. The knee is the highest rate whose
first-token tail stays flat and whose window finishes what it offers; the
benchmark's cell runs at a fixed rate below it. Not run by the benchmark.
"""

import argparse
import asyncio
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402
from portbench.drivers.serve import Serve  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args()
    cell = harness.load_json(harness.HERE / "workloads"
                             / f"{a.workload}.json")
    harness.set_environment(cell, False)
    r = harness.make_run(a.workload, a.seed, a.seconds, False, "cuda",
                         cell=cell)
    sv = Serve(r)

    async def go():
        sv.build()
        await sv.warm()
        for rate in a.rates:
            sv.cell["rate_hz"] = rate
            sv.records = []
            t = time.perf_counter()
            win = await sv.window(a.seconds)
            e2e = sv.end_to_end(win)
            print(json.dumps({
                "rate_hz": rate, "offered": len(sv.measured()),
                "failed": sum(1 for x in sv.measured() if sv.failed(x)),
                "late_s_max": max(sv.late_s) if sv.late_s else 0.0,
                "drain_s": time.perf_counter() - t - a.seconds,
                **e2e}), flush=True)
        await sv.stop()

    asyncio.run(go())
    return 0


if __name__ == "__main__":
    sys.exit(main())
