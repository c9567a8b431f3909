"""CK-CLAIM: declarative acquire/release pairing — leaks on any path.

The Rust reference gets this from the borrow checker: a value that owns
a resource either reaches its drop or moves into something that will.
This checker is the Python tree's substitute, generalizing CK-WIRE's
original socket/fd escape analysis into a *declared* rule table: each
:class:`ClaimRule` names a paired API — acquire calls, the release that
balances them, and the module that implements the pair (excluded from
analysis: ``pin`` may call ``ref`` inside ``kvpool/table.py``) — and
every acquisition must provably reach its release on all paths,
exception edges included, or hand ownership to something longer-lived.

Rules in force:

- **fd** (migrated from CK-WIRE arm 2): ``open`` / ``socket.socket`` /
  ``create_connection`` / ``urlopen`` / ``.accept()`` / ``wire.connect``
  must be closed, ``with``-owned, returned, or stored.
- **kvpool page claims**: ``pool.alloc()`` (and the engine's
  ``_alloc_page`` wrapper) must reach ``unref`` or hand the page id into
  a table/list an owner releases; ``pool.ref``/``pool.pin`` taken in a
  loop must be balanced by ``unref``/``unpin`` or the page list must be
  handed off (``rec["pages"] = pages``) *before* anything between can
  raise — a ``pin()`` whose hand-off sits after a device dispatch leaks
  pinned pages forever the day that dispatch throws.
- **disagg transfer ids**: an ``import_begin`` registration must flow
  into ``import_attach``/``import_abort`` or be stored for the resume
  handler; an orphaned one pins pool pages until the TTL sweep.
- **spill-store reservations**: a ``spill_begin`` claim must
  reach ``spill_commit`` or ``spill_abort`` on every path — a leaked
  reservation shrinks the bounded host-RAM store for every later
  preemption.

What counts as a release (per rule): an explicit release call
(``x.close()``; ``unref(pid)``/``unpin(pid)`` — including a loop
``for p in pages: pool.unpin(p)`` over the claimed list), a hand-off
(``return``/``yield`` the token, use it as an assignment RHS, pass it
to a container store like ``append``/``register``), or a protecting
``try`` whose handler/finally releases it (enclosing the acquisition,
or the very next statement after it). Release calls and effect-style
claim calls (``ref``/``unref``/``pin``/``unpin``) are never "risky"
statements — they are part of the protocol being checked — but a
binding acquisition between a held claim and its release IS risky: a
second ``create_connection`` that raises strands the first socket.

Effect-style claims (``pool.pin(pid)`` — no bound result) track the
claim through one container hop: a pin inside a loop whose tokens are
appended to a local list transfers the claim to that list, which must
then be released or handed off like a bound resource.
"""

from __future__ import annotations

import ast
import dataclasses

from cake_tpu_torch.analysis import core


@dataclasses.dataclass(frozen=True)
class ClaimRule:
    """One declared acquire/release pair.

    ``patterns`` match the acquiring call's attribute chain:

    - ``"open"`` — exact bare name;
    - ``".accept"`` — method call (any receiver);
    - ``"socket.socket"`` — last two chain segments;
    - ``"pool*.pin"`` — method whose receiver chain mentions ``pool``.

    ``release_methods`` are released as ``token.close()``;
    ``release_funcs`` as ``unref(token)`` (any receiver), including the
    loop form over a claimed list. ``style`` is ``"binding"`` (the
    acquire's result is the token: ``s = open(p)``) or ``"effect"``
    (the acquire's first argument is: ``pool.pin(pid)``). ``exclude``
    lists the modules that *implement* the pair.
    """

    rule: str
    style: str  # "binding" | "effect"
    patterns: tuple[str, ...]
    release_methods: tuple[str, ...] = ()
    release_funcs: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()
    hint: str = ""


# the modules that implement the page claims
_KVPOOL = ("cake_tpu_torch/kvpool/table.py", "cake_tpu_torch/kvpool/prefix.py")

CLAIM_RULES = (
    ClaimRule(
        rule="fd",
        style="binding",
        patterns=("open", "socket.socket", ".create_connection",
                  ".urlopen", ".accept", "wire*.connect"),
        release_methods=("close",),
        hint="close it in a finally, or use `with`",
    ),
    ClaimRule(
        rule="kvpool.page",
        style="binding",
        patterns=("pool*.alloc", "._alloc_page"),
        release_funcs=("unref",),
        exclude=_KVPOOL,
        hint="unref it on the error path, or hand it to the stream "
             "table / prefix tree before anything can raise",
    ),
    ClaimRule(
        rule="kvpool.ref",
        style="effect",
        patterns=("pool*.ref",),
        release_funcs=("unref",),
        exclude=_KVPOOL,
        hint="balance with unref, or hand the page list to its owner "
             "before anything can raise",
    ),
    ClaimRule(
        rule="kvpool.pin",
        style="effect",
        patterns=("pool*.pin",),
        release_funcs=("unpin",),
        exclude=_KVPOOL,
        hint="unpin in a finally, or hand the pinned list to the import "
             "record/owner BEFORE any statement that can raise",
    ),
    ClaimRule(
        rule="disagg.import",
        style="binding",
        patterns=(".import_begin",),
        release_funcs=("import_attach", "import_abort"),
        exclude=("cake_tpu_torch/runtime/batch_generator.py",),
        hint="attach or abort the transfer, or store its meta for the "
             "resume handler",
    ),
    ClaimRule(
        rule="gateway.lease",
        style="binding",
        patterns=("._lease_acquire",),
        release_funcs=("_lease_release",),
        hint="append the member to the fleet list (the monitor owns its "
             "lease from there) or release it before anything can raise",
    ),
    ClaimRule(
        rule="gateway.admit",
        style="binding",
        patterns=("._admit_enter",),
        release_funcs=("_admit_exit",),
        hint="release the admission-queue slot in a finally — a leaked "
             "slot shrinks the queue for every later request",
    ),
    ClaimRule(
        rule="serve.spill",
        style="binding",
        patterns=(".spill_begin",),
        release_funcs=("spill_commit", "spill_abort"),
        exclude=("cake_tpu_torch/serve/spill.py",),
        hint="commit the spilled payload or abort the claim in an "
             "except/finally — a leaked reservation shrinks the store "
             "for every later preemption",
    ),
)

# Calls that are never "risky statements" between an acquisition and
# its release: declared releases, and effect-style claim calls (pin/ref
# take a claim on an EXISTING token — part of the protocol under check,
# the `alloc; pin; unref; append` loop idiom). Binding-style acquires
# (open/connect/alloc/import_begin) stay risky on purpose: a second
# dial that raises strands the first socket — the classic double-
# acquisition leak.
_NONRISKY_NAMES = frozenset(
    {p.rsplit(".", 1)[-1] for r in CLAIM_RULES if r.style == "effect"
     for p in r.patterns}
    | {m for r in CLAIM_RULES for m in r.release_methods}
    | {f for r in CLAIM_RULES for f in r.release_funcs}
)

# Method names that store their argument in a longer-lived owner —
# passing a resource to one of these is an ownership hand-off, same as
# `self.x = var` (a bare helper call like `_set_keepalive(sock)` is NOT:
# helpers use, owners store).
_STORE_METHODS = {"append", "add", "put", "insert", "register", "push",
                  "setdefault"}


def _match_pattern(chain: list[str], pattern: str) -> bool:
    if not chain:
        return False
    if "." not in pattern:
        return chain == [pattern]
    head, name = pattern.rsplit(".", 1)
    if chain[-1] != name:
        return False
    if head == "":  # ".accept": any method receiver
        return len(chain) >= 2
    if head.endswith("*"):  # "pool*.pin": receiver mentions the stem
        stem = head[:-1].lower()
        return any(stem in part.lower() for part in chain[:-1])
    return len(chain) >= 2 and chain[-2] == head


def _acquisition(call: ast.Call, rule: ClaimRule) -> str | None:
    """Short label if this call acquires under ``rule``."""
    chain = core.attr_chain(call.func)
    for pat in rule.patterns:
        if _match_pattern(chain, pat):
            return pat.rsplit(".", 1)[-1].lstrip("*") or pat
    return None


class ClaimChecker(core.Checker):
    id = "CK-CLAIM"
    name = "claim-lifecycle"
    description = ("declared acquire/release pairs (fds, kvpool page "
                   "claims, transfer ids) reach their release or a "
                   "hand-off on every path, exception edges included")

    def check_module(self, mod: core.Module):
        rules = [r for r in CLAIM_RULES if mod.rel not in r.exclude]
        if not rules:
            return
        # one walk per module, every rule matched per call (not one
        # walk per rule): the rule table grows, the tree traversals
        # shouldn't
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            for rule in rules:
                kind = _acquisition(node, rule)
                if kind is None:
                    continue
                stmt = core.statement_of(node)
                if stmt is None or self._inside_with(node):
                    continue
                if rule.style == "binding":
                    finding = self._classify_binding(mod, node, stmt, kind,
                                                     rule)
                else:
                    finding = self._classify_effect(mod, node, stmt, kind,
                                                    rule)
                if finding is not None:
                    yield finding

    # -- shared machinery -------------------------------------------------
    @staticmethod
    def _inside_with(node) -> bool:
        """Acquisition used as (or inside) a `with` context expression."""
        for anc in core.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    if node in ast.walk(item.context_expr):
                        return True
        return False

    @staticmethod
    def _where(node) -> str:
        fn = core.enclosing_function(node)
        return getattr(fn, "name", "<module>") if fn is not None \
            else "<module>"

    @staticmethod
    def _hands_off(expr, var) -> bool:
        """True if ``expr`` passes ownership of ``var`` somewhere — the
        var appears as a VALUE (bare name, call argument, container
        element), not merely as the receiver of a method call:
        ``Connection(sock=sock)`` hands off, ``data = sock.recv(n)`` is
        just a read and the caller still owns the socket."""
        for n in ast.walk(expr):
            if (isinstance(n, ast.Name) and n.id == var
                    and not isinstance(core.parent(n), ast.Attribute)):
                return True
        return False

    @classmethod
    def _release_call(cls, node, var, rule: ClaimRule) -> bool:
        """An explicit release of ``var`` under ``rule``: ``var.close()``,
        ``unref(var)``, or the loop form ``for p in var: unref(p)``."""
        if not isinstance(node, ast.Call):
            return False
        if (rule.release_methods
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in rule.release_methods
                and core.attr_chain(node.func.value) == [var]):
            return True
        if rule.release_funcs and core.call_name(node) in rule.release_funcs:
            for a in node.args:
                # the arg derives from the token: unref(var), or
                # import_abort(var["xfer_id"]) — releasing through a
                # projection of the claim releases the claim
                if any(isinstance(n, ast.Name) and n.id == var
                       for n in ast.walk(a)):
                    return True
                if isinstance(a, ast.Name):
                    # loop release: unref(p) inside `for p in var:`
                    for anc in core.ancestors(node):
                        if (isinstance(anc, ast.For)
                                and isinstance(anc.target, ast.Name)
                                and anc.target.id == a.id
                                and isinstance(anc.iter, ast.Name)
                                and anc.iter.id == var):
                            return True
        return False

    @classmethod
    def _releases(cls, node, var, rule: ClaimRule) -> bool:
        """Release OR hand-off of ``var`` at ``node``."""
        if isinstance(node, (ast.Return, ast.Yield)) and node.value \
                is not None and cls._hands_off(node.value, var):
            return True
        if isinstance(node, ast.Assign) and cls._hands_off(node.value, var):
            return True
        if cls._release_call(node, var, rule):
            return True
        if (isinstance(node, ast.Call)
                and core.call_name(node) in _STORE_METHODS
                and any(cls._hands_off(a, var) for a in node.args)):
            return True  # conns.append(var): stored in an owner
        return False

    @classmethod
    def _first_release(cls, root, acq_stmt, var, rule: ClaimRule):
        """First post-acquisition release/hand-off node."""
        acq_nodes = set(map(id, ast.walk(acq_stmt)))
        best = None
        for node in ast.walk(root):
            line = getattr(node, "lineno", None)
            if line is None or line < acq_stmt.lineno \
                    or id(node) in acq_nodes:
                continue
            if cls._releases(node, var, rule) and (
                    best is None or line < best.lineno):
                best = node
        return best

    @staticmethod
    def _next_stmt(stmt):
        """The statement executed after ``stmt`` on the fallthrough
        path: its next sibling, lifting through enclosing blocks (a
        statement that ends a try body continues at the try's
        successor)."""
        cur = stmt
        while cur is not None:
            p = core.parent(cur)
            for field in ("body", "orelse", "finalbody"):
                lst = getattr(p, field, None)
                if isinstance(lst, list) and cur in lst:
                    i = lst.index(cur)
                    if i + 1 < len(lst):
                        return lst[i + 1]
                    break
            cur = p if isinstance(p, ast.stmt) else (
                core.statement_of(p) if p is not None
                and not isinstance(p, ast.Module) else None)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
        return None

    @classmethod
    def _protected(cls, acq_stmt, var, rule: ClaimRule) -> bool:
        """A try that actually covers the held-bare region and releases
        the var in a handler or finally: either it encloses the
        acquisition, or it is the very next statement after it (nothing
        can raise in between)."""
        def closes(nodes) -> bool:
            for n in nodes:
                for c in ast.walk(n):
                    if cls._release_call(c, var, rule):
                        return True
            return False

        def try_closes(t) -> bool:
            return isinstance(t, ast.Try) and (
                closes(t.finalbody) or closes(t.handlers))

        for anc in core.ancestors(acq_stmt):
            if try_closes(anc):
                return True
        nxt = cls._next_stmt(acq_stmt)
        return try_closes(nxt)

    @staticmethod
    def _risky_between(root, acq_stmt, release) -> bool:
        """Any call strictly between acquisition and release that can
        raise while the claim is held bare. Excluded: release calls and
        effect-style claim calls (part of the protocol under check —
        binding acquires are NOT excluded, a second dial can strand the
        first), calls inside the release's own statement (`if cond:
        var.close()` — the test belongs to the release), and calls
        inside the handlers/orelse of the try wrapping the acquisition
        (the claim is unheld on those paths)."""
        lo = acq_stmt.end_lineno or acq_stmt.lineno
        release_stmt = core.statement_of(release)
        excluded = set(map(id, ast.walk(release_stmt))) if release_stmt \
            is not None else set()
        if release_stmt is not None:
            # the guard of a conditional release (`if stop: var.close()`)
            # is part of the release decision, not held-bare work
            for anc in core.ancestors(release_stmt):
                if isinstance(anc, (ast.If, ast.While)):
                    excluded.update(map(id, ast.walk(anc.test)))
        for anc in core.ancestors(acq_stmt):
            if isinstance(anc, ast.Try) and acq_stmt in anc.body:
                for part in (*anc.handlers, *anc.orelse):
                    excluded.update(map(id, ast.walk(part)))
                break
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and id(node) not in excluded:
                if core.call_name(node) in _NONRISKY_NAMES:
                    continue
                line = getattr(node, "lineno", 0)
                if lo < line < release.lineno:
                    return True
        return False

    # -- binding style: token = acquire(...) -------------------------------
    def _classify_binding(self, mod, call, stmt, kind, rule: ClaimRule):
        # baseline keys are qualified by the enclosing function so one
        # grandfathered leak can't silently cover a future same-named
        # variable elsewhere in the file
        where = self._where(call)
        # unbound acquisition: fine when the same expression releases it
        # (`wire.connect(...).close()`) or stores it in an owner
        # (`self.pool.append(open(p))`); otherwise it's simply dropped
        if isinstance(stmt, ast.Expr):
            p = core.parent(call)
            if (isinstance(p, ast.Attribute)
                    and p.attr in (rule.release_methods or ("close",))):
                return None
            for anc in core.ancestors(call):
                if isinstance(anc, ast.Call) and (
                        core.call_name(anc) in _STORE_METHODS
                        or core.call_name(anc) in rule.release_funcs):
                    return None
            return self.finding(
                mod, call,
                f"{kind}(...) result is dropped without a release "
                f"[{rule.rule}]",
                hint=rule.hint or "bind it and release it",
                key=f"res:{kind}:{where}:dropped",
            )
        if not isinstance(stmt, ast.Assign):
            return None  # return open(...) etc.: caller owns it
        # self.x = open(...) / handles[k] = ... : owner object manages it
        targets = []
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                targets.append(t.id)
            elif isinstance(t, ast.Tuple):
                targets.extend(e.id for e in t.elts
                               if isinstance(e, ast.Name))
            else:
                return None  # attribute/subscript target: ownership moved
        if not targets:
            return None
        var = targets[0]
        fn = core.enclosing_function(stmt)
        body_root = fn if fn is not None else mod.tree
        return self._track(mod, call, stmt, body_root, var, kind, rule)

    # -- effect style: pool.pin(token) -------------------------------------
    def _classify_effect(self, mod, call, stmt, kind, rule: ClaimRule):
        where = self._where(call)
        fn = core.enclosing_function(call)
        body_root = fn if fn is not None else mod.tree
        tok = call.args[0] if call.args else None
        tok_name = tok.id if isinstance(tok, ast.Name) else None
        loop = next((a for a in core.ancestors(stmt)
                     if isinstance(a, ast.For)), None)
        carrier, claim_stmt = None, stmt
        if loop is not None and tok_name is not None:
            claim_stmt = loop
            if (isinstance(loop.target, ast.Name)
                    and loop.target.id == tok_name
                    and isinstance(loop.iter, ast.Name)):
                # `for pid in table: pool.pin(pid)` — the claim is on the
                # iterated list
                carrier = loop.iter.id
            else:
                # `for _ in range(n): pid = alloc(); pin(pid);
                #  pages.append(pid)` — the claim transfers to the list
                # collecting the tokens
                for n in ast.walk(loop):
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr in _STORE_METHODS
                            and isinstance(n.func.value, ast.Name)
                            and any(isinstance(a, ast.Name)
                                    and a.id == tok_name
                                    for a in n.args)):
                        carrier = n.func.value.id
                        break
            if carrier is None:
                # per-iteration claim on a plain name (`pid = s.pid;
                # pin(pid); ...; unpin(pid)`): no collecting list, so
                # track the name itself within the iteration instead of
                # giving up as untrackable
                carrier, claim_stmt = tok_name, stmt
        elif tok_name is not None:
            carrier = tok_name
        if carrier is None:
            # untrackable token (subscript/expression arg — a plain
            # name always resolves a carrier above): accept only a
            # protecting try with a wildcard release
            if self._wildcard_protected(claim_stmt, rule):
                return None
            # qualify the key by the token EXPRESSION so one
            # grandfathered untracked claim cannot silently baseline a
            # different one later added to the same function
            tok_src = ast.unparse(tok) if tok is not None else "<no-arg>"
            return self.finding(
                mod, call,
                f"{kind}(...) claim cannot be tracked to a release "
                f"[{rule.rule}]: its token is neither a name nor "
                "collected into a list",
                hint=rule.hint,
                key=f"claim:{rule.rule}:{where}:untracked:{tok_src}",
            )
        return self._track(mod, call, claim_stmt, body_root, carrier,
                           kind, rule, key_prefix=f"claim:{rule.rule}")

    @classmethod
    def _wildcard_protected(cls, acq_stmt, rule: ClaimRule) -> bool:
        """A protecting try whose handler/finally makes ANY release_funcs
        call — the escape hatch for tokens the tracker cannot name."""
        def closes(nodes) -> bool:
            for n in nodes:
                for c in ast.walk(n):
                    if (isinstance(c, ast.Call)
                            and core.call_name(c) in rule.release_funcs):
                        return True
            return False

        for anc in core.ancestors(acq_stmt):
            if isinstance(anc, ast.Try) and (
                    closes(anc.finalbody) or closes(anc.handlers)):
                return True
        nxt = cls._next_stmt(acq_stmt)
        return isinstance(nxt, ast.Try) and (
            closes(nxt.finalbody) or closes(nxt.handlers))

    def _track(self, mod, call, claim_stmt, body_root, var, kind,
               rule: ClaimRule, key_prefix: str = "res"):
        where = self._where(call)
        release = self._first_release(body_root, claim_stmt, var, rule)
        if release is None:
            if self._protected(claim_stmt, var, rule):
                return None
            return self.finding(
                mod, call,
                f"{kind}(...) claim on '{var}' is never released, "
                f"stored, or returned in this function [{rule.rule}]",
                hint=rule.hint,
                key=f"{key_prefix}:{kind}:{where}:{var}",
            )
        if self._protected(claim_stmt, var, rule):
            return None
        if not self._risky_between(body_root, claim_stmt, release):
            return None  # released immediately: nothing can raise first
        return self.finding(
            mod, call,
            f"'{var}' ({kind} claim) can leak: statements between the "
            f"acquisition (line {claim_stmt.lineno}) and its release "
            f"(line {release.lineno}) may raise, and no try/finally "
            f"releases it [{rule.rule}]",
            hint=rule.hint or f"wrap the in-between work in try/except "
                 f"releasing '{var}' on the error path",
            key=f"{key_prefix}:{kind}:{where}:{var}",
        )
