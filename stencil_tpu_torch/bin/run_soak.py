"""Chaos soak: bitwise continuity across preemptions, grid moves and
serving faults, on PyTorch + CUDA.

Counterpart of ``scripts/run_soak.py``, with its three stories and its
artifacts (``soak_summary.json``, ``serve_summary.json``, a flight-recorder
heartbeat in ``--out-dir``):

1. **kill/resume** (default): a REFERENCE run of the jacobi3d driver
   (``python -m stencil_tpu_torch.bin.jacobi3d``) completes ``--iters``
   samples under the checkpoint supervisor, unkilled; its final ring
   checkpoint's manifest carries a sha256 per quantity.  A CHAOS run of the
   same workload is killed at ``--kills`` seeded points (alternating
   SIGKILL, no cleanup, and SIGTERM, which the supervisor answers with a
   final checkpoint and exit code 75), delivered from inside the process by
   the ``STENCIL_FAULT_PLAN`` hooks (``dispatch:sigkill:jacobi@K``), each
   followed by a relaunch with ``--resume``.  The final manifests must
   match digest for digest.
2. **--reshard**: the chaos run also takes ``shrink`` / ``grow`` notices
   (the supervisor's in-memory ``DistributedDomain.reshard`` between the
   configured subdomain count and half of it) at >= 2 seeded points among
   the kills; the digests then pin continuity across grid moves too, and
   the summary records each move's seconds.
3. **--serve**: reference-vs-chaos pairs of the serving driver
   (``python -m stencil_tpu_torch.bin.stencil_serve``, 3 tenants): a
   ``poison_request`` evicts only its tenant and a ``vmem_oom`` is answered
   inside its tenant's envelope, every other tenant's final-field digest
   bitwise equal to the reference; an injected ``overload`` sheds without
   evicting; the elastic leg decides exactly one grow and one shrink,
   bitwise equal to its fixed-grid twin; the batched (``--batch 8``) and
   sub-slice legs reproduce the reference digest for digest while engaging,
   and a poisoned batch falls back to serial with its healthy members
   bitwise equal.  The verdict is ``isolation_ok`` in
   ``serve_summary.json``; ``telemetry/ledger.py`` ingests the reference
   leg's p99 and shed rate only when it holds.

The runs use the cuda engine on the card (``--device cuda``, the default;
without a GPU this raises the port's no-GPU error).  ``--dryrun`` runs
everything on the CPU (``--device cpu``: the kernels' plain versions):
one subdomain for the kills, two under ``--reshard`` (a grid must have
somewhere to shrink), four under ``--serve`` (the elastic legs start on
two).  ``--in-process`` runs the serve legs through ``stencil_serve.main``
in this process instead of a process each.

    python -m stencil_tpu_torch.bin.run_soak --dryrun
    python -m stencil_tpu_torch.bin.run_soak --dryrun --reshard
    python -m stencil_tpu_torch.bin.run_soak --dryrun --serve
    python -m stencil_tpu_torch.bin.run_soak --serve --serve-size 512 --serve-subdomains 8 --serve-steps 8
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import time

#: the supervisor's resumable exit (sysexits EX_TEMPFAIL)
EXIT_RESUMABLE = 75

#: the directory holding the package: the drivers' processes import it from
#: there, wherever the soak runs from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_soak", description="chaos soak (see the module docstring)")
    p.add_argument("--iters", type=int, default=24, help="total driver samples")
    p.add_argument("--checkpoint-every", type=int, default=4, help="supervisor step cadence")
    p.add_argument("--keep", type=int, default=3, help="retention-ring size")
    p.add_argument("--kills", type=int, default=3, help="seeded kill points (>= 3 for the chaos proof)")
    p.add_argument("--seed", type=int, default=20260803, help="kill-point RNG seed")
    p.add_argument("--size", nargs=3, type=int, default=[16, 16, 16], metavar=("X", "Y", "Z"))
    p.add_argument("--out-dir", default="soak_out", metavar="DIR")
    p.add_argument(
        "--max-launches", type=int, default=24,
        help="safety valve on driver relaunches (a resume loop that stops "
        "making progress must fail loudly, not spin)",
    )
    p.add_argument(
        "--dryrun", action="store_true",
        help="run every driver on the CPU (--device cpu): the whole chaos "
        "story anywhere (numbers are not perf)",
    )
    p.add_argument(
        "--reshard", action="store_true",
        help="seed >= 2 shrink/grow notices (in-memory reshards) into the "
        "chaos run, interleaved with the kills",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="run the SERVING-LAYER chaos story instead (module docstring)",
    )
    p.add_argument("--serve-cycles", type=int, default=20, help="load-generator cycles per serve leg")
    p.add_argument("--serve-size", type=int, default=8, help="cubic domain edge of each serve tenant")
    p.add_argument("--serve-steps", type=int, default=1, help="raw steps per serve request")
    p.add_argument(
        "--serve-subdomains", type=int, default=None,
        help="the serve fleet's slots (default 4; elastic legs start on half)",
    )
    p.add_argument("--in-process", action="store_true",
                   help="run the serve legs through stencil_serve.main in this process")
    return p


def _device(args) -> str:
    return "cpu" if args.dryrun else "cuda"


def _check_device(args) -> None:
    """Raise the port's no-GPU error before any driver starts, unless the
    CPU was asked for (``--dryrun``)."""
    from stencil_tpu_torch.device import resolve_device

    resolve_device(_device(args))


def _env(fault_plan: str = "") -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    env.pop("STENCIL_FAULT_PLAN", None)
    if fault_plan:
        env["STENCIL_FAULT_PLAN"] = fault_plan
    return env


def driver_cmd(args, ckpt_dir: str, resume: bool) -> list:
    cmd = [
        sys.executable, "-m", "stencil_tpu_torch.bin.jacobi3d",
        *(str(v) for v in args.size),
        "--no-weak-scale",
        "--iters", str(args.iters),
        "--device", _device(args),
        "--checkpoint-dir", ckpt_dir,
        "--checkpoint-every", str(args.checkpoint_every),
        "--checkpoint-keep", str(args.keep),
    ]
    if args.reshard:
        # a grid with somewhere to shrink: the supervisor's shrink halves it
        cmd += ["--partition", "2,1,1"]
    if resume:
        cmd.append("--resume")
    return cmd


def driver_env(args, fault_plan: str = "") -> dict:
    env = _env(fault_plan)
    # npz checkpoints: the portable backend, quick to write a relaunch
    env.setdefault("STENCIL_CHECKPOINT_BACKEND", "npz")
    return env


def launch(args, ckpt_dir: str, resume: bool, fault_plan: str = "") -> int:
    cmd = driver_cmd(args, ckpt_dir, resume)
    proc = subprocess.run(cmd, env=driver_env(args, fault_plan), capture_output=True, text=True)
    if proc.returncode not in (0, EXIT_RESUMABLE) and not fault_plan:
        print(proc.stdout, file=sys.stderr)
        print(proc.stderr, file=sys.stderr)
        raise SystemExit(f"unexpected driver failure rc={proc.returncode}")
    return proc.returncode


def final_manifest(ckpt_dir: str) -> dict:
    from stencil_tpu_torch.io.checkpoint import latest_valid

    found = latest_valid(ckpt_dir)
    if found is None:
        raise SystemExit(f"no valid checkpoint under {ckpt_dir}")
    return found[1]


def ring_progress(ckpt_dir: str) -> int:
    from stencil_tpu_torch.io.checkpoint import ring_entries

    entries = ring_entries(ckpt_dir)
    return entries[-1][0] if entries else 0


def harvest_transitions(ckpt_dir: str) -> list:
    """Grid moves recorded by the LAST driver process's flight recorder
    (each process heartbeats its own history into the checkpoint dir's
    status.json; read right after the launch, before the next process
    overwrites it)."""
    from stencil_tpu_torch.telemetry.flight import read_status

    status = read_status(ckpt_dir) or {}
    return list(status.get("mesh_history") or [])


# --- the serving-layer chaos story (--serve) -------------------------------


def serve_argv(args, out: str, extra: list) -> list:
    """The serving driver's command line of one leg (after ``-m <module>``)."""
    sub = args.serve_subdomains if args.serve_subdomains is not None else 4
    return [
        "--tenants", "3", "--size", str(args.serve_size),
        "--cycles", str(args.serve_cycles), "--peak", "4",
        "--steps", str(args.serve_steps),
        "--device", _device(args),
        "--subdomains", str(sub),
        "--out", out, *extra,
    ]


def _serve_in_process(argv: list, fault_plan: str) -> None:
    """One leg through ``stencil_serve.main`` in this process: the fault
    plan installed (and named in the environment, which the summary
    records) for the leg only, the counters zeroed first so the leg's
    summary counts its own."""
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.bin import stencil_serve
    from stencil_tpu_torch.resilience import inject

    saved = os.environ.pop(inject.ENV_VAR, None)
    telemetry.reset()
    try:
        if fault_plan:
            os.environ[inject.ENV_VAR] = fault_plan
        inject.set_plan(fault_plan or None)
        rc = stencil_serve.main(argv)
    finally:
        inject.set_plan(None)
        os.environ.pop(inject.ENV_VAR, None)
        if saved is not None:
            os.environ[inject.ENV_VAR] = saved
    if rc != 0:
        raise SystemExit(f"serve leg failed rc={rc}")


def serve_leg(args, name: str, extra: list, fault_plan: str = "") -> dict:
    """One serving-driver run; returns its serve_summary.json."""
    out = os.path.join(args.out_dir, name)
    shutil.rmtree(out, ignore_errors=True)
    argv = serve_argv(args, out, extra)
    print(f"== serve leg {name!r} (plan {fault_plan!r})", file=sys.stderr)
    if args.in_process:
        _serve_in_process(argv, fault_plan)
    else:
        proc = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.bin.stencil_serve", *argv],
                              env=_env(fault_plan), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, file=sys.stderr)
            print(proc.stderr, file=sys.stderr)
            raise SystemExit(f"serve leg {name!r} failed rc={proc.returncode}")
    with open(os.path.join(out, "serve_summary.json")) as f:
        return json.load(f)


def serve_checks(ref, poison, vmem, overload, batched, sub, bpoison, el, el_fix) -> dict:
    """The isolation / overload / elasticity / packing verdicts of the nine
    legs' summaries (``scripts/run_soak.py``'s checks)."""

    def states(doc):
        return {t["tenant"]: t["state"] for t in doc["tenants"]}

    def healthy_identical(doc, faulted):
        return all(doc["digests"][t] == ref["digests"][t] for t in ref["digests"] if t != faulted)

    return {
        # the poisoned tenant is evicted/quarantined, nobody else moves a bit
        "poison_isolated": states(poison)["tenant-b"] != "active" and healthy_identical(poison, "tenant-b"),
        # the OOMing tenant is answered inside its own envelope
        "vmem_isolated": (
            states(vmem)["tenant-c"] != "active"
            or any(t["rung"] > 0 for t in vmem["tenants"] if t["tenant"] == "tenant-c")
        )
        and healthy_identical(vmem, "tenant-c"),
        # overload sheds load, never tenants
        "overload_sheds_not_evicts": overload["shed"] >= 1
        and all(s == "active" for s in states(overload).values()),
        # elasticity: exactly one grow + one shrink, bitwise = the fixed grid
        "elastic_bitwise": el["digests"] == el_fix["digests"],
        "elastic_one_grow_one_shrink": el["elasticity"]["decisions"] == ["grow", "shrink"]
        and sorted({t["kind"] for t in el["elasticity"]["transitions"]}) == ["grow", "shrink"],
        # batched dispatch reproduces the serial reference digest for digest
        # AND engaged (a trivially serial run matching digests proves nothing)
        "batched_bitwise": batched["digests"] == ref["digests"]
        and batched["counters"].get("serve.batch.dispatches", 0) > 0,
        # sub-slice bin-packing likewise: digests identical, slices placed
        "subslice_bitwise": sub["digests"] == ref["digests"]
        and sub["counters"].get("serve.subslice.dispatches", 0) > 0,
        # poison against one member of a batch: the batch falls back to
        # serial re-execution, the poisoned tenant is evicted, and every
        # HEALTHY member stays bitwise equal to the fault-free reference
        "batched_poison_isolated": states(bpoison)["tenant-b"] != "active"
        and healthy_identical(bpoison, "tenant-b")
        and bpoison["counters"].get("serve.batch.fallbacks", 0) >= 1,
    }


def serve_soak(args) -> int:
    """Reference-vs-chaos serving pairs: the isolation/overload/elasticity
    acceptance proof (module docstring).  Returns the process exit code."""
    from stencil_tpu_torch.telemetry.flight import FlightRecorder
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    _check_device(args)
    os.makedirs(args.out_dir, exist_ok=True)
    flight = FlightRecorder(args.out_dir, label="serve_soak")
    elastic = ["--elastic", "--elastic-high", "4", "--elastic-low", "0", "--elastic-consecutive", "3"]
    flight.heartbeat(0, 9, stage="reference")
    ref = serve_leg(args, "ref", [])
    flight.heartbeat(1, 9, stage="poison")
    poison = serve_leg(args, "poison", [], fault_plan="execute:poison_request:serve:tenant-b@1")
    flight.heartbeat(2, 9, stage="vmem")
    vmem = serve_leg(args, "vmem", [], fault_plan="execute:vmem_oom:serve:tenant-c@1")
    flight.heartbeat(3, 9, stage="overload")
    overload = serve_leg(args, "overload", [], fault_plan="dispatch:overload:serve:*@2*3")
    flight.heartbeat(4, 9, stage="batched")
    batched = serve_leg(args, "batched", ["--batch", "8"])
    flight.heartbeat(5, 9, stage="subslice")
    sub = serve_leg(args, "subslice", ["--subslice"])
    flight.heartbeat(6, 9, stage="batched-poison")
    bpoison = serve_leg(args, "batched_poison", ["--batch", "8"],
                        fault_plan="execute:poison_request:serve:tenant-b@1")
    flight.heartbeat(7, 9, stage="elastic")
    el = serve_leg(args, "elastic", elastic)
    flight.heartbeat(8, 9, stage="elastic-fixed")
    el_fix = serve_leg(args, "elastic_fixed", elastic + ["--fixed-mesh"])

    checks = serve_checks(ref, poison, vmem, overload, batched, sub, bpoison, el, el_fix)
    isolation_ok = all(checks.values())
    summary = {
        "bench": "serve_soak",
        "dryrun": bool(args.dryrun),
        "cycles": args.serve_cycles,
        "tenants": ref["tenants"],
        "requests": ref["requests"],
        "p99_ms": ref["p99_ms"],
        "shed_rate": ref["shed_rate"],
        "overload_shed": overload["shed"],
        "checks": checks,
        "digests": {
            "ref": ref["digests"],
            "poison": poison["digests"],
            "vmem": vmem["digests"],
            "batched": batched["digests"],
            "subslice": sub["digests"],
            "batched_poison": bpoison["digests"],
            "elastic": el["digests"],
            "elastic_fixed": el_fix["digests"],
        },
        # the packed leg's throughput is the headline the perf ledger tracks
        # (higher-is-better serve:throughput); the serial reference rides
        # along so a reader sees the batching change in one artifact
        "throughput": batched.get("throughput"),
        "throughput_ref": ref.get("throughput"),
        "elasticity": el["elasticity"],
        "device": ref.get("device"),
        "kernel_impl": ref.get("kernel_impl"),
        "isolation_ok": isolation_ok,
    }
    path = os.path.join(args.out_dir, "serve_summary.json")
    atomic_write_json(path, summary)
    print(json.dumps(summary))
    flight.heartbeat(9, 9, phase="completed" if isolation_ok else "failed", stage="verify",
                     isolation_ok=isolation_ok)
    if not isolation_ok:
        failed = [k for k, ok in checks.items() if not ok]
        flight.crash_report("serve_isolation", error=f"failed checks: {failed}", checks=checks)
        print(f"FAIL: serve soak checks failed: {failed}", file=sys.stderr)
        return 1
    print(
        "OK: poison/vmem isolated bitwise, overload shed "
        f"{overload['shed']} without evictions, batched/subslice packed "
        "legs bitwise identical (poison-in-batch fell back serial), "
        f"elasticity one grow + one shrink bitwise identical ({path})",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.serve:
        return serve_soak(args)
    if args.iters < args.kills + 2:
        raise SystemExit("--iters must leave room for every kill plus a resume")
    _check_device(args)
    os.makedirs(args.out_dir, exist_ok=True)
    ref_dir = os.path.join(args.out_dir, "ref")
    chaos_dir = os.path.join(args.out_dir, "chaos")
    for d in (ref_dir, chaos_dir):
        shutil.rmtree(d, ignore_errors=True)

    # the soak's own flight recorder: status.json in the out dir says which
    # stage and kill the harness is at (`python -m stencil_tpu_torch.status
    # <out-dir>`); each chaos driver heartbeats into its checkpoint dir
    from stencil_tpu_torch.telemetry.flight import FlightRecorder

    flight = FlightRecorder(args.out_dir, label="soak")
    flight.heartbeat(0, args.iters, stage="reference")
    print(f"== reference run: {args.iters} iters unkilled", file=sys.stderr)
    rc = launch(args, ref_dir, resume=False)
    if rc != 0:
        raise SystemExit(f"reference run failed rc={rc}")
    ref = final_manifest(ref_dir)
    assert ref["step"] == args.iters, (ref["step"], args.iters)

    rng = random.Random(args.seed)
    kills = []
    transitions = []
    progress = 0
    launches = 0
    chaos_t0 = time.monotonic()
    for i in range(args.kills):
        # a seeded dispatch AHEAD of current progress, strictly before the
        # end so there is always work left to resume; alternate the signal
        # so BOTH preemption shapes are exercised every soak
        remaining = args.iters - progress
        offset = rng.randrange(0, max(remaining - 1, 1))
        sig = "sigkill" if i % 2 == 0 else "sigterm"
        plan = f"dispatch:{sig}:jacobi@{offset}"
        capacity = []
        if args.reshard and i < 2:
            # capacity notices STRICTLY before this launch's kill: launch 0
            # shrinks then grows back in one process, launch 1 shrinks and
            # dies shrunken (the next launch's restore re-fits the checkpoint
            # onto the configured grid).  Each notice that fires shifts the
            # kill by one dispatch (fire() returns at the first firing entry),
            # so the clamp leaves room for offset + n_cap before the end.
            n_cap = 2 if i == 0 else 1
            offset = min(max(offset, 3), max(remaining - 2 - n_cap, 1))
            capacity = ["shrink@0", "grow@1"] if i == 0 else [f"shrink@{max(offset - 2, 0)}"]
            plan = ",".join(
                [f"dispatch:{c.split('@')[0]}:jacobi@{c.split('@')[1]}" for c in capacity]
                + [f"dispatch:{sig}:jacobi@{offset}"]
            )
            offset += n_cap  # the EFFECTIVE kill dispatch (recorded below)
        print(f"== chaos kill {i + 1}/{args.kills}: {sig} at dispatch {progress}+{offset} (plan {plan!r})",
              file=sys.stderr)
        flight.heartbeat(progress, args.iters, stage=f"chaos-kill-{i + 1}/{args.kills}", signal=sig,
                         at_dispatch=progress + offset)
        rc = launch(args, chaos_dir, resume=i > 0, fault_plan=plan)
        launches += 1
        expected = EXIT_RESUMABLE if sig == "sigterm" else None
        if rc == 0:
            raise SystemExit(f"kill {i + 1}: driver completed despite {plan!r} (rc=0)")
        if expected is not None and rc != expected:
            raise SystemExit(f"kill {i + 1}: sigterm run exited rc={rc}, want {expected}")
        if args.reshard:
            transitions.extend(harvest_transitions(chaos_dir))
        new_progress = ring_progress(chaos_dir)
        kills.append({"kill": i + 1, "signal": sig, "at_dispatch": progress + offset, "capacity_hooks": capacity,
                      "rc": rc, "checkpointed_step": new_progress})
        progress = new_progress
    # resume until clean completion (bounded: a resume loop that stops
    # making progress fails loudly)
    while True:
        print(f"== resume from step {progress}", file=sys.stderr)
        flight.heartbeat(progress, args.iters, stage="resume", launches=launches)
        rc = launch(args, chaos_dir, resume=True)
        launches += 1
        if args.reshard:
            transitions.extend(harvest_transitions(chaos_dir))
        if rc == 0:
            break
        progress = ring_progress(chaos_dir)
        if launches > args.max_launches:
            raise SystemExit(f"no clean completion after {launches} launches")
    recovery_seconds = time.monotonic() - chaos_t0
    reshard_seconds = [t["seconds"] for t in transitions if t.get("kind") == "reshard"]
    if args.reshard and len(reshard_seconds) < 2:
        raise SystemExit(f"--reshard soak completed only {len(reshard_seconds)} in-memory transitions (< 2); "
                         f"transitions seen: {transitions}")

    chaos = final_manifest(chaos_dir)
    ref_digests = {q["name"]: q["digest"] for q in ref["quantities"]}
    chaos_digests = {q["name"]: q["digest"] for q in chaos["quantities"]}
    identical = ref_digests == chaos_digests and chaos["step"] == ref["step"]

    summary = {
        "bench": "soak_kill_resume",
        "dryrun": bool(args.dryrun),
        "reshard": bool(args.reshard),
        "iters": args.iters,
        "checkpoint_every": args.checkpoint_every,
        "seed": args.seed,
        "kills": kills,
        "launches": launches,
        # per-move in-memory reshard seconds and the chaos phase's wall
        # clock: telemetry/ledger.py ingests them as the lower-is-better
        # `reshard:seconds` and `soak:recovery_seconds` series
        "transitions": transitions,
        "reshard_seconds": reshard_seconds,
        "recovery_seconds": round(recovery_seconds, 3),
        "final_step": {"ref": ref["step"], "chaos": chaos["step"]},
        "digests": {"ref": ref_digests, "chaos": chaos_digests},
        "bitwise_identical": identical,
        "device": _device(args),
    }
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    path = os.path.join(args.out_dir, "soak_summary.json")
    atomic_write_json(path, summary)
    print(json.dumps(summary))
    flight.heartbeat(chaos["step"], args.iters, phase="completed" if identical else "failed", stage="verify",
                     launches=launches, bitwise_identical=identical)
    if not identical:
        flight.crash_report("soak_mismatch", error="resumed fields differ from the unkilled run",
                            digests=summary["digests"])
        print("FAIL: resumed fields differ from the unkilled run", file=sys.stderr)
        return 1
    print(
        f"OK: {args.kills} kills, {launches} launches"
        + (f", {len(reshard_seconds)} in-memory grid moves" if args.reshard else "")
        + f", fields bitwise identical to the unkilled run ({path})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
