"""CK-WIRE: wire-protocol safety — recv deadlines + protocol arms.

Two arms, both encoding lessons this repo already paid for (the third
original arm — socket/fd leak escape analysis — migrated into the
declarative CK-CLAIM framework, :mod:`cake_tpu_torch.analysis.claims`, as its
``fd`` rule):

1. **recv deadlines** — a ``settimeout(None)`` hole lets one wedged
   peer pin a master forever; the wire has per-op deadlines.
   Every ``Connection.recv(...)`` call must therefore pass ``timeout=``
   explicitly: a value, or a visible ``timeout=None`` that documents
   "block forever" as a decision instead of a default. (Raw
   ``socket.recv(n)`` byte reads — positional size arg — are out of
   scope; the framing layer bounds those.)

2. **protocol arms** — a protocol member with a decode arm but no encode
   arm (or vice versa) is dead weight at best and a skew trap at worst.
   Cross-module pass over BOTH protocol vocabularies in the tree: every
   ``MsgType`` enum member needs at least one send site
   (``conn.send(MsgType.X, ...)``) and one dispatch site
   (``t == MsgType.X`` / ``t in (MsgType.X, ...)``), and so does every
   frame constant in the declared :data:`FRAME_CONST_GROUPS` families —
   the disagg transfer channel's ``XFER_*`` ints ride the same wire
   framing without an enum, and skew hides there just as well.
"""

from __future__ import annotations

import ast

from cake_tpu_torch.analysis import core

# Frame-constant protocol families: (module rel, constant-name prefix).
# Members are module-level ALL-CAPS ints; send/dispatch arms are judged
# tree-wide exactly like MsgType members.
FRAME_CONST_GROUPS = (
    ("cake_tpu_torch/disagg/transfer.py", "XFER_"),
)


class WireSafetyChecker(core.Checker):
    id = "CK-WIRE"
    name = "wire-safety"
    description = ("Connection.recv passes an explicit timeout; every "
                   "MsgType member and declared frame constant has "
                   "encode and decode arms")

    # -- arm 1: recv deadlines --------------------------------------------
    def check_module(self, mod: core.Module):
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "recv"):
                continue
            if node.args:
                continue  # socket.recv(nbytes): framed layer bounds it
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            recv_of = ".".join(core.attr_chain(node.func.value)) or "<expr>"
            yield self.finding(
                mod, node,
                f"'{recv_of}.recv()' without an explicit timeout — a "
                "wedged peer blocks this thread forever",
                hint="pass timeout=<seconds> (or an explicit timeout=None "
                     "to document block-forever as a decision)",
                key=f"recv:{recv_of}",
            )

    # -- arm 2: protocol encode/decode arms --------------------------------
    def finalize(self, mods):
        yield from self._check_msgtype(mods)
        yield from self._check_frame_consts(mods)

    def _check_msgtype(self, mods):
        enum_mod, enum_cls = self._find_enum(mods)
        if enum_cls is None:
            return
        members = [
            t.targets[0].id
            for t in enum_cls.body
            if isinstance(t, ast.Assign) and len(t.targets) == 1
            and isinstance(t.targets[0], ast.Name)
            and t.targets[0].id.isupper()
        ]
        sends: set[str] = set()
        dispatches: set[str] = set()
        for mod in mods:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                chain = core.attr_chain(node)
                if len(chain) < 2 or "MsgType" not in chain[-2]:
                    continue
                member = chain[-1]
                if member not in members:
                    continue
                use = self._usage(node)
                if use == "send":
                    sends.add(member)
                elif use == "dispatch":
                    dispatches.add(member)
        yield from self._missing_arms(enum_mod, enum_cls, "MsgType.",
                                      members, sends, dispatches,
                                      key_fmt="MsgType.{member}:{arm}")

    def _check_frame_consts(self, mods):
        by_rel = {m.rel: m for m in mods}
        for rel, prefix in FRAME_CONST_GROUPS:
            mod = by_rel.get(rel)
            if mod is None:
                continue  # family module not in this (full) scan surface
            anchors: dict[str, ast.AST] = {}
            for stmt in mod.tree.body:
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and stmt.targets[0].id.startswith(prefix)
                        and stmt.targets[0].id.isupper()
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, int)):
                    anchors[stmt.targets[0].id] = stmt
            sends: set[str] = set()
            dispatches: set[str] = set()
            for m in mods:
                for node in ast.walk(m.tree):
                    name = None
                    if isinstance(node, ast.Name) and node.id in anchors:
                        name = node.id
                    elif isinstance(node, ast.Attribute) \
                            and node.attr in anchors:
                        name = node.attr  # re-exported: transfer.XFER_ACK
                    if name is None:
                        continue
                    use = self._usage(node)
                    if use == "send":
                        sends.add(name)
                    elif use == "dispatch":
                        dispatches.add(name)
            for member, anchor in anchors.items():
                yield from self._missing_arms(
                    mod, anchor, "frame constant ", [member],
                    sends, dispatches, key_fmt="frame:{member}:{arm}")

    def _missing_arms(self, mod, anchor, label, members, sends,
                      dispatches, key_fmt):
        for member in members:
            missing = [arm for arm, have in (("send", sends),
                                             ("dispatch", dispatches))
                       if member not in have]
            for arm in missing:
                verb = ("is never sent (no encode arm)" if arm == "send"
                        else "is never dispatched on (no decode arm)")
                yield self.finding(
                    mod, anchor,
                    f"{label}{member} {verb} anywhere in the tree",
                    hint="wire both arms, or baseline a deliberate "
                         "one-sided member (e.g. reference-protocol "
                         "compat) with a justification",
                    key=key_fmt.format(member=member, arm=arm),
                )

    @staticmethod
    def _find_enum(mods):
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef) and node.name == "MsgType":
                    return mod, node
        return None, None

    @staticmethod
    def _usage(attr_node) -> str | None:
        """send (first arg of a .send call), dispatch (in a comparison),
        or neither (docs, aliasing)."""
        prev = attr_node
        for anc in core.ancestors(attr_node):
            if isinstance(anc, ast.Call):
                if (isinstance(anc.func, ast.Attribute)
                        and anc.func.attr == "send"
                        and anc.args and prev in (anc.args[0],
                                                  *ast.walk(anc.args[0]))):
                    return "send"
            if isinstance(anc, ast.Compare):
                return "dispatch"
            prev = anc
        return None
