"""deploy: push code and per-worker bundles to topology hosts and start
workers (port of ``cake_tpu/tools/deploy.py``; the same commands, with the
port's command line as the worker).

For each host-addressed worker of the topology:

1. rsync the repo to ``--repo-dest`` (VCS, caches and checkpoints left
   out);
2. rsync the worker's ``<name>-node`` bundle (``tools/split_model.py``'s
   layout: ``model/reduced.safetensors``, its index and a single-worker
   ``topology.yml``) from ``--bundles`` to ``--data-dest``;
3. with ``--start``: launch ``python -m cake_tpu_torch.cli --mode worker``
   on the host, bound to the node's port, over its own bundle and
   topology, through ``ssh ... nohup``.

Commands are only printed by default (a dry run); ``--run`` executes them.
``--ssh-user``/``--ssh-opts`` go to both rsync and ssh.

Usage:
  python -m cake_tpu_torch.tools.deploy --topology topology.yml \\
      --bundles ./bundles --repo-dest /srv/cake-tpu \\
      --data-dest /srv/cake-data [--start] [--run]
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
from pathlib import Path

from cake_tpu_torch.parallel.topology import Topology

RSYNC_EXCLUDES = (
    ".git", "__pycache__", ".r4_tpu", "*.safetensors", "bundles",
    "cake-data", ".pytest_cache",
    # excluded paths are also protected from --delete: a redeploy must
    # never unlink the logs the started workers are writing into repo_dest
    "worker-*.log",
)


def _host_port(node) -> tuple[str, int]:
    """Split a node's ``host:port`` address (reference topology.yaml
    format); port defaults to the reference's 10128."""
    host = node.host
    if ":" in host:
        h, p = host.rsplit(":", 1)
        return h, int(p)
    return host, 10128


def plan_commands(
    topology: Topology,
    repo_root: str,
    bundles: str | None,
    repo_dest: str,
    data_dest: str,
    start: bool = False,
    ssh_user: str = "",
    ssh_opts: str = "",
    python: str = "python3",
) -> list[list[str]]:
    """Build the per-host command list (pure — this is what the dry run
    prints and the tests assert on)."""
    cmds: list[list[str]] = []
    ssh_base = ["ssh"] + (shlex.split(ssh_opts) if ssh_opts else [])
    # rsync re-splits -e on whitespace: quote per token so an ssh option
    # whose value contains spaces (-o ProxyCommand=...) survives the trip
    rsh = shlex.join(ssh_base) if len(ssh_base) > 1 else "ssh"
    excludes = [f"--exclude={e}" for e in RSYNC_EXCLUDES]
    for name, node in topology.nodes.items():
        host, port = _host_port(node)
        if not host:
            continue  # device:-only node: lives on the mesh, not a host
        target = f"{ssh_user}@{host}" if ssh_user else host
        cmds.append(
            ["rsync", "-rvzc", "--delete", "-e", rsh, *excludes,
             f"{repo_root.rstrip('/')}/", f"{target}:{repo_dest}/"]
        )
        if bundles:
            bundle = str(Path(bundles) / f"{name}-node")
            cmds.append(
                ["rsync", "-rvzc", "-e", rsh, f"{bundle}/",
                 f"{target}:{data_dest}/{name}-node/"]
            )
        if start:
            worker_cmd = (
                f"cd {shlex.quote(repo_dest)} && nohup {python} -m "
                f"cake_tpu_torch.cli --mode worker --address 0.0.0.0:{port} "
                f"--model {shlex.quote(f'{data_dest}/{name}-node/model')} "
                f"--topology "
                f"{shlex.quote(f'{data_dest}/{name}-node/topology.yml')} "
                f"--name {shlex.quote(name)} "
                f"> {shlex.quote(f'worker-{name}.log')} 2>&1 &"
            )
            cmds.append([*ssh_base, target, worker_cmd])
    return cmds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--topology", required=True)
    ap.add_argument("--bundles", default=None,
                    help="split_model output root holding <name>-node dirs "
                         "(omit to sync code only)")
    ap.add_argument("--repo-dest", default="/srv/cake-tpu")
    ap.add_argument("--data-dest", default="/srv/cake-data")
    ap.add_argument("--start", action="store_true",
                    help="also start each worker over ssh")
    ap.add_argument("--run", action="store_true",
                    help="execute the commands (default: dry-run print)")
    ap.add_argument("--ssh-user", default="")
    ap.add_argument("--ssh-opts", default="")
    ap.add_argument("--python", default="python3")
    args = ap.parse_args(argv)

    topo = Topology.from_path(args.topology)
    repo_root = str(Path(__file__).resolve().parents[2])
    cmds = plan_commands(
        topo, repo_root, args.bundles, args.repo_dest, args.data_dest,
        start=args.start, ssh_user=args.ssh_user, ssh_opts=args.ssh_opts,
        python=args.python,
    )
    if not cmds:
        sys.stderr.write("topology has no host-addressed workers\n")
        return 1
    for cmd in cmds:
        print(" ".join(shlex.quote(c) for c in cmd))
        if args.run:
            r = subprocess.run(cmd)
            if r.returncode != 0:
                sys.stderr.write(
                    f"command failed (rc={r.returncode}); stopping\n")
                return r.returncode
    if not args.run:
        sys.stderr.write(f"dry run: {len(cmds)} commands printed "
                         "(pass --run to execute)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
