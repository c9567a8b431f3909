"""Topology: the distribution config plane (port of
``cake_tpu/parallel/topology.py``, framework-free, copied).

A map of worker-name -> ``{host, description, layers}`` where each layers
entry is either a single layer name or a range ``model.layers.0-5``
expanded to individual names (``stop > start`` validated). Lookups:
``get_node_for_layer`` and the prefix-match ``is_layer_owner``;
``segments`` plans the master's walk into maximal same-owner runs.

The file is YAML, read with PyYAML where it is installed. A JSON document
is valid YAML, so a JSON topology loads in both packages; without PyYAML
the file is read as JSON, and a file that is not JSON then raises an error
that names PyYAML. A node may carry ``device: <int>`` (the JAX package's
mesh-stage extension); the port parses it, and its command line refuses
such topologies until multi-device parallelism is ported.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

_RANGE_RE = re.compile(r"^(.+[^\d])(\d+)-(\d+)$")


def _load(text: str, path) -> dict:
    """A topology file's mapping: YAML through PyYAML where it is
    installed, else JSON."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError as e:
            raise ValueError(
                f"{path} is not JSON, and reading it as YAML needs PyYAML, "
                "which is not installed (write the topology as JSON, or "
                "install PyYAML)") from e
    return yaml.safe_load(text)


def expand_layer_ranges(entries: list[str]) -> list[str]:
    """Expand range entries to individual layer names."""
    out: list[str] = []
    for entry in entries:
        m = _RANGE_RE.match(entry)
        if m:
            prefix, start, stop = m.group(1), int(m.group(2)), int(m.group(3))
            if stop <= start:
                raise ValueError(
                    f"invalid layer range '{entry}': stop must be > start"
                )
            out.extend(f"{prefix}{i}" for i in range(start, stop + 1))
        else:
            out.append(entry)
    return out


@dataclasses.dataclass
class Node:
    """One worker's assignment (topology.rs:13-32).

    ``host`` may be given in YAML as a single address OR a list of
    addresses — the replica set for this segment, in failover order. The
    master connects to the first and, when a mid-stream recovery deadline
    for it expires, fails over to the next (every replica must serve the
    same layers; the handshake enforces it). ``host`` always holds the
    primary; ``hosts`` the full ordered set."""

    name: str
    host: str = ""
    description: str = ""
    layers: list[str] = dataclasses.field(default_factory=list)
    device: int | None = None  # mesh stage index (refused by the port)
    hosts: list[str] | None = None  # replica addresses (failover order)

    def __post_init__(self):
        if isinstance(self.host, (list, tuple)):  # YAML list under `host:`
            self.hosts = [str(h) for h in self.host]
            self.host = self.hosts[0] if self.hosts else ""
        elif self.hosts is None:
            self.hosts = [self.host] if self.host else []
        elif self.host and self.host not in self.hosts:
            self.hosts = [self.host] + list(self.hosts)
        elif not self.host and self.hosts:
            self.host = self.hosts[0]

    def is_layer_owner(self, full_name: str) -> bool:
        """Prefix match used by the splitter (topology.rs:25-32): does this
        node own the layer a tensor like
        ``model.layers.3.self_attn.q_proj.weight`` belongs to?"""
        return any(
            full_name == l or full_name.startswith(l + ".") for l in self.layers
        )

    def layer_indices(self, prefix: str = "model.layers.") -> list[int]:
        """Sorted numeric indices of this node's decoder layers."""
        idx = []
        for l in self.layers:
            if l.startswith(prefix):
                tail = l[len(prefix):]
                if tail.isdigit():
                    idx.append(int(tail))
        return sorted(idx)


class Topology:
    """Ordered worker-name -> Node mapping with layer lookups."""

    def __init__(self, nodes: dict[str, Node]):
        self.nodes = nodes

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        nodes = {}
        for name, spec in (d or {}).items():
            spec = spec or {}
            nodes[name] = Node(
                name=name,
                host=spec.get("host", ""),
                description=spec.get("description", ""),
                layers=expand_layer_ranges(list(spec.get("layers", []))),
                device=spec.get("device"),
            )
        return cls(nodes)

    @classmethod
    def from_path(cls, path: str | Path) -> "Topology":
        return cls.from_dict(_load(Path(path).read_text(), path))

    def to_dict(self) -> dict:
        out = {}
        for name, n in self.nodes.items():
            # round-trip the replica list when there is one; a single
            # address stays the scalar form every pre-replica tool reads
            host = (list(n.hosts) if n.hosts and len(n.hosts) > 1
                    else n.host)
            spec: dict = {"host": host, "description": n.description,
                          "layers": list(n.layers)}
            if n.device is not None:
                spec["device"] = n.device
            out[name] = spec
        return out

    def save(self, path: str | Path) -> None:
        """YAML with PyYAML, else JSON (which both loaders read)."""
        try:
            import yaml
        except ImportError:
            text = json.dumps(self.to_dict(), indent=1) + "\n"
        else:
            text = yaml.safe_dump(self.to_dict(), sort_keys=False)
        Path(path).write_text(text)

    def get_node_for_layer(self, layer_name: str) -> Node | None:
        """First node listing ``layer_name`` (topology.rs:75-84)."""
        for node in self.nodes.values():
            if layer_name in node.layers:
                return node
        return None

    # -- dict-like surface (topology.rs:87-98 Deref) ------------------------
    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __iter__(self):
        return iter(self.nodes.values())

    def __len__(self) -> int:
        return len(self.nodes)

    # -- planning helpers ---------------------------------------------------
    def segments(self, num_layers: int, prefix: str = "model.layers.") -> list["Segment"]:
        """Partition ``0..num_layers`` into maximal contiguous runs with a
        single owner each — the coalescing the reference does per decode step
        (llama.rs:88-119: contiguous blocks with equal ``ident()`` batch into
        one RPC), computed once here because the assignment is static."""
        segs: list[Segment] = []
        for i in range(num_layers):
            owner = self.get_node_for_layer(f"{prefix}{i}")
            owner_name = owner.name if owner else None
            if segs and segs[-1].owner == owner_name and segs[-1].stop == i:
                segs[-1] = dataclasses.replace(segs[-1], stop=i + 1)
            else:
                segs.append(Segment(start=i, stop=i + 1, owner=owner_name))
        return segs


@dataclasses.dataclass(frozen=True)
class Segment:
    """A maximal contiguous layer run ``[start, stop)`` owned by one node
    (``owner None`` = local to the master)."""

    start: int
    stop: int
    owner: str | None

    @property
    def length(self) -> int:
        return self.stop - self.start
