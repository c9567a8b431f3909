"""Live cluster watch: every worker's status page as a refreshing terminal
table (port of ``cake_tpu/tools/watch.py``; the same table).

Workers serve their state as JSON (``--status-port``, ``runtime/worker.py
status()``); this tool shows one row a worker, refreshed in place, with
ops/s and byte rates taken from the counters' change between frames.

Usage:
    python -m cake_tpu_torch.tools.watch host1:8090 host2:8090
    python -m cake_tpu_torch.tools.watch --topology topology.yml --port 8090
    ... --interval 2       # refresh period (s)
    ... --once             # one snapshot, no screen control (scripts/CI)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


def fetch_status(host: str, timeout: float = 2.0) -> dict:
    """One worker's status dict, or an ``{"error": ...}`` marker row —
    a dead worker must show as DOWN in the table, not kill the watch."""
    url = f"http://{host}/"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception as e:  # connection refused / timeout / bad JSON
        return {"error": str(e)[:80]}


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TiB"


def render(hosts: list[str], snaps: list[dict], prev: dict,
           dt: float) -> str:
    """One table frame. ``prev`` maps host -> last snapshot (for counter
    deltas); mutated in place so the caller just re-calls."""
    hdr = (f"{'worker':<22} {'device':<12} {'layers':<12} {'conns':>5} "
           f"{'ops/s':>8} {'in/s':>10} {'out/s':>10} {'rss':>9} "
           f"{'uptime':>8}")
    lines = [hdr, "-" * len(hdr)]
    for host, s in zip(hosts, snaps):
        if "error" in s:
            # drop the stale snapshot: on recovery the counter delta would
            # span every missed interval but be divided by one dt,
            # inflating the displayed rates N-fold for a frame
            prev.pop(host, None)
            lines.append(f"{host:<22} DOWN: {s['error']}")
            continue
        p = prev.get(host)
        if p and dt > 0:
            ops_s = max(0.0, (s["ops_total"] - p["ops_total"]) / dt)
            in_s = max(0.0, (s["bytes_in"] - p["bytes_in"]) / dt)
            out_s = max(0.0, (s["bytes_out"] - p["bytes_out"]) / dt)
        else:
            ops_s = in_s = out_s = 0.0
        prev[host] = s
        runs = ",".join(f"{a}-{b - 1}" for a, b in s["layer_runs"])
        name = f"{s['name']}@{host}"
        lines.append(
            f"{name:<22.22} {s['device']:<12.12} {runs:<12.12} "
            f"{s['connections_live']:>5} {ops_s:>8.1f} "
            f"{_human(in_s):>10} {_human(out_s):>10} "
            f"{_human(s['rss_bytes']):>9} {s['uptime_s']:>7.0f}s"
        )
    return "\n".join(lines)


def hosts_from_topology(path: str, port: int) -> list[str]:
    """Status hosts from the same topology YAML the cluster runs on: the
    worker's serving address's host + the shared status port."""
    from cake_tpu_torch.parallel.topology import Topology

    topo = Topology.from_path(path)
    return [f"{n.host.rsplit(':', 1)[0]}:{port}"
            for n in topo.nodes.values() if n.host]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("hosts", nargs="*",
                    help="worker status pages as host:port")
    ap.add_argument("--topology", default=None,
                    help="derive hosts from a topology YAML instead")
    ap.add_argument("--port", type=int, default=8090,
                    help="status port for --topology hosts")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen control)")
    args = ap.parse_args(argv)

    hosts = list(args.hosts)
    if args.topology:
        hosts += hosts_from_topology(args.topology, args.port)
    if not hosts:
        ap.error("no hosts: pass host:port arguments or --topology")

    from concurrent.futures import ThreadPoolExecutor

    prev: dict = {}
    last_t = time.monotonic()
    # concurrent fetches bound a frame at max(one fetch) instead of the
    # sum — a few firewalled/hung hosts must not freeze the live table
    pool = ThreadPoolExecutor(max_workers=min(32, len(hosts)))
    while True:
        snaps = list(pool.map(fetch_status, hosts))
        now = time.monotonic()
        frame = render(hosts, snaps, prev, now - last_t)
        last_t = now
        if args.once:
            print(frame)
            return 0 if all("error" not in s for s in snaps) else 1
        # in-place refresh: clear screen + home (plain ANSI, no curses —
        # works over ssh and in dumb terminals with --once as the out)
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
