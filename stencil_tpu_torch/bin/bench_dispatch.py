"""Host cost of the ``run_step`` dispatch boundary, and the routes' speed.

For each route of ``chip_smoke.py``'s phase 17 (Jacobi 512^3 ``wrap`` on
one subdomain, the z-ring wavefront on 2x2x2, 511^3 ``auto`` and ``shell``
on 2x2x2; Astaroth 8 x 512^3 ``wavefront`` on one subdomain and ``auto`` /
``per-step`` on 2x2x2 under ``direct`` and ``yzpack_pallas``, fused and
split), built uncaptured and captured through the models' entry points with
every knob at its default, it measures:

* ``mcells_per_s`` (Jacobi) or ``ms_per_iter`` (Astaroth): the best of 7
  calls of 200 steps or 24 iterations, each ending in a synchronize;
* ``host_us_per_call``: the host clock of those calls, from the call to its
  return (no synchronize inside), their median;
* ``host_us_per_step1``: the host µs of a ``step(1)`` call, the median of 7
  runs of 100 calls with no synchronize between them (the boundary's own
  cost weighs most here).

Before the routes, ``boundary_us``: the host µs of ``run_step`` itself, on
a 64^3 card domain with a step that returns its input at once (the median
of 7 runs of 20,000 calls): what the dispatch boundary costs a call; and
``exchange_us``: the host µs of ``exchange()`` on the same domain, one
quantity with a radius-1 shell on 2x2x2 (the median of 7 runs of 2,000
calls, a synchronize after each run): the exchange's issue cost, which the
card's work at this size does not hide.

It uses only the models' constructors, ``dd.set_partition`` and ``step``,
so the same file measures any tree of the port: run it with that tree
first on ``PYTHONPATH``.  To compare two trees on one card, run them in one
call, parent, change, change, parent:

    PYTHONPATH=<tree> python3 stencil_tpu_torch/bin/bench_dispatch.py --tag <name> [--only jacobi]

One JSON line per route on stdout, and ``chiprun_out/bench_dispatch_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from stencil_tpu_torch.kernels import toolchain

N, NU, STEPS, AST_Q, AST_ITERS = 512, 511, 200, 8, 24


def _sync() -> None:
    torch.cuda.synchronize()


def _routes():
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    def jacobi(size, part=None, **kw):
        def make(captured):
            m = Jacobi3D(size, size, size, kernel_impl="cuda", capture=captured, **kw)
            if part is not None:
                m.dd.set_partition(*part)
            m.realize()
            return m
        return make

    def astaroth(part=None, **kw):
        def make(captured):
            m = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", capture=captured, **kw)
            if part is not None:
                m.dd.set_partition(*part)
            m.realize()
            return m
        return make

    g = (2, 2, 2)
    return [
        (f"jacobi wrap {N}^3 1x1x1", jacobi(N), N ** 3, STEPS),
        (f"jacobi wavefront z-ring {N}^3 2x2x2", jacobi(N, g), N ** 3, STEPS),
        (f"jacobi auto {NU}^3 2x2x2", jacobi(NU, g), NU ** 3, STEPS),
        (f"jacobi shell {NU}^3 2x2x2", jacobi(NU, g, pallas_path="shell"), NU ** 3, STEPS),
        ("astaroth wavefront 1x1x1", astaroth(schedule="wavefront"), None, AST_ITERS),
        ("astaroth auto 2x2x2 direct", astaroth(g), None, AST_ITERS),
        ("astaroth per-step 2x2x2 direct", astaroth(g, schedule="per-step"), None, AST_ITERS),
        ("astaroth auto 2x2x2 yzpack_pallas", astaroth(g, exchange_route="yzpack_pallas"), None, AST_ITERS),
        ("astaroth per-step 2x2x2 yzpack_pallas",
         astaroth(g, schedule="per-step", exchange_route="yzpack_pallas"), None, AST_ITERS),
        ("astaroth per-step 2x2x2 yzpack_pallas fused",
         astaroth(g, schedule="per-step", exchange_route="yzpack_pallas", stream_halo="fused"), None, AST_ITERS),
        ("astaroth auto 2x2x2 yzpack_pallas fused",
         astaroth(g, exchange_route="yzpack_pallas", stream_halo="fused"), None, AST_ITERS),
        ("astaroth per-step 2x2x2 direct split", astaroth(g, schedule="per-step", stream_overlap="split"), None,
         AST_ITERS),
        ("astaroth auto 2x2x2 direct split", astaroth(g, stream_overlap="split"), None, AST_ITERS),
    ]


def boundary_us() -> dict:
    """``run_step``'s own host µs a call (module docstring)."""
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(64, 64, 64)
    dd.set_radius(1)
    dd.add_data("q")
    dd.set_partition(2, 2, 2)
    dd.realize()

    def step(curr, steps=1):
        return curr

    runs = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(20000):
            dd.run_step(step, 1)
        runs.append((time.perf_counter() - t0) / 20000 * 1e6)
    return {"median": statistics.median(runs), "runs": runs}


def exchange_us() -> dict:
    """``exchange()``'s host µs a call (module docstring)."""
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(64, 64, 64)
    dd.set_radius(1)
    dd.add_data("q")
    dd.set_partition(2, 2, 2)
    dd.realize()
    for _ in range(200):
        dd.exchange()
    _sync()
    runs = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(2000):
            dd.exchange()
        runs.append((time.perf_counter() - t0) / 2000 * 1e6)
        _sync()
    return {"median": statistics.median(runs), "runs": runs}


def measure(make, cells, steps: int) -> dict:
    """Both captures of one route (module docstring)."""
    out = {}
    for captured in (False, True):
        model = make(captured)
        model.step(steps)  # builds, binds and captures; untimed
        _sync()
        dts, host = [], []
        for _ in range(7):
            _sync()
            t0 = time.perf_counter()
            model.step(steps)
            t1 = time.perf_counter()
            _sync()
            dts.append(time.perf_counter() - t0)
            host.append((t1 - t0) * 1e6)
        model.step(1)
        _sync()
        runs = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(100):
                model.step(1)
            runs.append((time.perf_counter() - t0) / 100 * 1e6)
            _sync()
        rec = {"host_us_per_call": statistics.median(host), "host_us_runs": host,
               "host_us_per_step1": statistics.median(runs),
               "host_us_per_step1_runs": runs}
        if cells is not None:
            rec["mcells_per_s"] = cells * steps / min(dts) / 1e6
        else:
            rec["ms_per_iter"] = min(dts) / steps * 1e3
        out["captured" if captured else "uncaptured"] = rec
        loop = getattr(model._step, "_loop", None)
        if loop is not None:
            loop.release()
        del model
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench-dispatch")
    p.add_argument("--tag", default="tree", help="name of the tree measured (the output file's suffix)")
    p.add_argument("--only", nargs="*", default=None, help="route names containing one of these words")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-dispatch: no CUDA device", file=sys.stderr)
        return 1
    card = toolchain()["card"]
    if card is None:
        raise RuntimeError("bench-dispatch: nvidia-smi did not report the card's name and power limit")
    import stencil_tpu_torch

    res = {"tag": args.tag, "card": card, "package": os.path.dirname(stencil_tpu_torch.__file__),
           "torch": torch.__version__, "boundary_us": boundary_us(), "exchange_us": exchange_us(), "routes": {}}
    print(json.dumps({"tag": args.tag, "boundary_us": res["boundary_us"], "exchange_us": res["exchange_us"]}),
          flush=True)
    for key, make, cells, steps in _routes():
        if args.only and not any(w in key for w in args.only):
            continue
        rec = measure(make, cells, steps)
        res["routes"][key] = rec
        print(json.dumps({"tag": args.tag, "route": key, **rec}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    atomic_write_json(os.path.join("chiprun_out", f"bench_dispatch_{args.tag}.json"), res)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
