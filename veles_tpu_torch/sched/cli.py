"""``python -m veles_tpu_torch sched serve|submit|status``
(``veles_tpu/sched/cli.py``).

``serve`` runs the scheduler and its loopback control endpoint and,
given ``--status-url``, posts a status blob to that dashboard's
``/update`` every 2 s (``veles_tpu_torch.web_status`` serves its jobs as
``/jobs.json`` and renders them as its jobs table). ``submit`` and
``status`` are thin HTTP clients of a running ``serve``.

Knobs (all resolvable per-invocation by flags; the env knobs are the
deployment defaults)::

    VELES_SCHED_POOL       device-slot count for `serve` (default 2)
    VELES_SCHED_TICK_S     scheduling pass interval (default 0.2)
    VELES_SCHED_ADDR       control endpoint host:port — `serve` binds
                           it, `submit`/`status` dial it
                           (default 127.0.0.1:4730)
    VELES_SCHED_PREEMPT    enable preemption (default on)
    VELES_SCHED_MIN_RUN_S  victim thrash guard seconds (default 1.0)
    VELES_SCHED_LOG_DIR    per-gang-member log directory (default:
                           inherit the scheduler's stdio)
    VELES_SCHED_STATE_DIR  durable state directory — the write-ahead
                           job journal + compacted snapshots live
                           here; a restart on the same dir recovers
                           every job and adopts surviving gangs
                           (default: in-memory only)
"""

import argparse
import json
import sys
import time
import urllib.request

from veles_tpu_torch.envknob import env_flag, env_knob

DEFAULT_ADDR = "127.0.0.1:4730"


def _default_addr():
    return env_knob("VELES_SCHED_ADDR", DEFAULT_ADDR)


def _split_addr(addr):
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _http(addr, path, payload=None, timeout=10.0):
    url = "http://%s/%s" % (addr, path.lstrip("/"))
    data = None
    headers = {}
    if payload is not None:
        data = json.dumps(payload).encode("utf-8")
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _serve_main(argv):
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch sched serve",
        description="run the gang scheduler + control endpoint")
    parser.add_argument("--pool", type=int, default=None,
                        help="device-slot count")
    parser.add_argument("--tick-s", type=float, default=None,
                        help="scheduling pass interval")
    parser.add_argument("--addr", default=None, metavar="HOST:PORT",
                        help="control endpoint to bind")
    parser.add_argument("--no-preempt", action="store_true",
                        help="disable preemption (jobs only place "
                             "into free holes)")
    parser.add_argument("--min-run-s", type=float, default=None,
                        help="victim must have run this long")
    parser.add_argument("--log-dir", default=None,
                        help="per-gang-member log files land here")
    parser.add_argument("--state-dir", default=None, metavar="DIR",
                        help="journal job state here and recover "
                             "from it at startup (adopting gangs "
                             "that survived the restart)")
    parser.add_argument("--status-url", default=None, metavar="URL",
                        help="web_status dashboard base URL to push "
                             "the jobs table to (e.g. "
                             "http://127.0.0.1:8090)")
    args = parser.parse_args(argv)
    # env knobs resolve OUTSIDE argparse defaults so a bad value fails
    # with the knob's name, and --help never triggers a parse
    pool = args.pool if args.pool is not None else \
        env_knob("VELES_SCHED_POOL", 2, parse=int)
    tick_s = args.tick_s if args.tick_s is not None else \
        env_knob("VELES_SCHED_TICK_S", 0.2, parse=float)
    addr = args.addr or _default_addr()
    preempt = (not args.no_preempt) and \
        env_flag("VELES_SCHED_PREEMPT", True)
    min_run_s = args.min_run_s if args.min_run_s is not None else \
        env_knob("VELES_SCHED_MIN_RUN_S", 1.0, parse=float)
    log_dir = args.log_dir or env_knob("VELES_SCHED_LOG_DIR")
    state_dir = args.state_dir or env_knob("VELES_SCHED_STATE_DIR")

    from veles_tpu_torch.sched.scheduler import Scheduler, SchedulerControl
    host, port = _split_addr(addr)
    scheduler = Scheduler(pool, tick_s=tick_s, preempt=preempt,
                          min_run_s=min_run_s, log_dir=log_dir,
                          state_dir=state_dir)
    # control first: clients get 503 + Retry-After during the replay
    # window instead of a connection refusal
    control = SchedulerControl(scheduler, host=host, port=port)
    control.start()
    scheduler.start()
    print("SCHED %s:%d pool=%d" % (control.address[0], control.port,
                                   pool), flush=True)
    try:
        while True:
            time.sleep(2.0)
            if args.status_url:
                _push_status(args.status_url, scheduler)
    except KeyboardInterrupt:
        pass
    finally:
        control.stop()
        scheduler.stop()
    return 0


def _push_status(base_url, scheduler):
    """POST the dashboard blob web_status's jobs table renders."""
    import os
    import socket
    blob = {"id": "sched-%s-%d" % (socket.gethostname(), os.getpid()),
            "name": "scheduler", "mode": "sched",
            "master": socket.gethostname(),
            "jobs": scheduler.jobs_report()["jobs"],
            "sched": scheduler.stats()}
    try:
        req = urllib.request.Request(
            base_url.rstrip("/") + "/update",
            data=json.dumps(blob).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=2.0)
    except OSError:
        pass   # the dashboard being down must not stop scheduling


def _submit_main(argv):
    exec_argv = None
    if "--" in argv:
        split = argv.index("--")
        exec_argv = argv[split + 1:]
        argv = argv[:split]
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch sched submit",
        description="submit one job (workflow [config] [overrides], "
                    "or a raw command after `--`)")
    parser.add_argument("spec", nargs="*",
                        help="workflow file, optional config file, "
                             "then path=value overrides")
    parser.add_argument("--addr", default=None, metavar="HOST:PORT")
    parser.add_argument("--name", default=None)
    parser.add_argument("--tenant", default="default")
    parser.add_argument("--qos", default="batch",
                        choices=("interactive", "batch",
                                 "best_effort"))
    parser.add_argument("--weight", type=float, default=1.0)
    parser.add_argument("--world", default="1", metavar="MIN[:MAX]",
                        help="elastic world-size range")
    parser.add_argument("--snapshots", default=None, metavar="DIR",
                        help="sharded checkpoint dir (makes the job "
                             "preemptible)")
    parser.add_argument("--result-file", default=None)
    parser.add_argument("-s", "--seed", type=int, default=None)
    parser.add_argument("--max-retries", type=int, default=0,
                        help="re-run a failed gang up to this many "
                             "times (exponential backoff) before "
                             "FAILED")
    parser.add_argument("--retry-backoff-s", type=float, default=1.0,
                        help="base backoff before a retry re-queues")
    parser.add_argument("--wait", action="store_true",
                        help="poll until the job is terminal; exit "
                             "0 only on DONE")
    args = parser.parse_args(argv)
    addr = args.addr or _default_addr()
    world_min, _, world_max = args.world.partition(":")
    spec = {"name": args.name, "tenant": args.tenant, "qos": args.qos,
            "weight": args.weight, "world_min": int(world_min),
            "world_max": int(world_max or world_min),
            "snapshot_dir": args.snapshots,
            "result_file": args.result_file, "seed": args.seed,
            "max_retries": args.max_retries,
            "retry_backoff_s": args.retry_backoff_s}
    if exec_argv:
        if args.spec:
            parser.error("give either workflow args or a `--` "
                         "command, not both")
        spec["argv"] = exec_argv
    elif args.spec:
        spec["workflow"] = args.spec[0]
        rest = args.spec[1:]
        overrides = {}
        for item in rest:
            if "=" in item:
                path, _, value = item.partition("=")
                overrides[path] = _literal(value)
            elif "config" not in spec or spec["config"] is None:
                spec["config"] = item
            else:
                parser.error("unexpected positional %r" % item)
        if overrides:
            spec["overrides"] = overrides
    else:
        parser.error("nothing to run: give a workflow file or a "
                     "`--` command")
    reply = _http(addr, "/submit", payload=spec)
    if "error" in reply:
        print("submit failed: %s" % reply["error"], file=sys.stderr)
        return 1
    print(reply["id"], flush=True)
    if not args.wait:
        return 0
    while True:
        jobs = {j["id"]: j for j in
                _http(addr, "/jobs.json")["jobs"]}
        job = jobs.get(reply["id"])
        if job is None:
            print("job %s vanished" % reply["id"], file=sys.stderr)
            return 1
        if job["state"] in ("done", "failed"):
            print("%s %s" % (job["id"], job["state"]), flush=True)
            return 0 if job["state"] == "done" else 1
        time.sleep(0.2)


def _literal(value):
    """Overrides come in as text; eval-free literal parsing keeps
    ints/floats/bools as the types ``%r`` would round-trip."""
    lowered = value.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    for parse in (int, float):
        try:
            return parse(value)
        except ValueError:
            continue
    return value


def _status_main(argv):
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch sched status",
        description="print a running scheduler's pool/tenant/job "
                    "state")
    parser.add_argument("--addr", default=None, metavar="HOST:PORT")
    parser.add_argument("--json", action="store_true",
                        help="raw JSON instead of the table")
    args = parser.parse_args(argv)
    addr = args.addr or _default_addr()
    stats = _http(addr, "/status")
    jobs = _http(addr, "/jobs.json")["jobs"]
    if args.json:
        print(json.dumps({"status": stats, "jobs": jobs}, indent=2))
        return 0
    pool = stats["pool"]
    print("pool: %d slots (%d held / %d free)"
          % (pool["size"], pool["held"], pool["free"]))
    for name, t in sorted(stats.get("tenants", {}).items()):
        print("tenant %-12s weight=%.1f qos=%-11s held=%d share=%s"
              % (name, t["weight"], t["qos"], t["held"], t["share"]))
    for job in jobs:
        print("%-8s %-10s %-24s tenant=%-10s world=%d preempts=%d%s"
              % (job["id"], job["state"], job["name"][:24],
                 job["tenant"], job["world"], job["preemptions"],
                 " error=%s" % job["error"] if job["error"] else ""))
    return 0


def sched_main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return _serve_main(rest)
    if cmd == "submit":
        return _submit_main(rest)
    if cmd == "status":
        return _status_main(rest)
    print("unknown command %r (serve | submit | status)" % cmd,
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(sched_main())
