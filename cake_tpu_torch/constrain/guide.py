"""Per-stream constrained-decoding state: one Guide per request (copy of
``cake_tpu/constrain/guide.py``).

A :class:`Guide` holds the host-side DFA cursor for one stream over a
shared (cached) :class:`~cake_tpu_torch.constrain.fsm.TokenDFA`. The DFA
*advance* is a host-side table lookup between decode steps, while the
*mask application* is a gather from the device-resident packed bitmask
table in the decode step, indexed by the engine's per-slot mask row. The
Guide exposes exactly the two numbers that plumbing needs: the current
``state`` (= mask row index within its DFA's block of table rows) and
``dead_end`` (the retire-with-finish_reason-"constraint" signal, counted
in ``constrain.dead_ends``).
"""

from __future__ import annotations

import numpy as np

from cake_tpu_torch.constrain.fsm import (
    TokenDFA,
    cached_token_strings,
    compile_constraint,
    spec_to_regex,
)
from cake_tpu_torch.obs import metrics as obs_metrics

# incremented by the engines when a constrained stream is retired at a
# state with an all-zero mask (no token, not even EOS, can be emitted)
DEAD_ENDS = obs_metrics.counter("constrain.dead_ends")


class Guide:
    """Host-side DFA cursor for one constrained stream.

    ``spec`` (optional) is the serve-plane ``response_format`` body the
    DFA compiled from. Carrying it lets the disagg plane export a
    constrained stream mid-grammar: the snapshot ships the spec + the
    integer cursor, and the importer recompiles the (cached) DFA and
    resumes exactly where the exporter stopped.
    """

    def __init__(self, dfa: TokenDFA, spec: dict | None = None):
        self.dfa = dfa
        self.spec = spec
        self.state = dfa.start

    def reset(self) -> None:
        self.state = self.dfa.start

    def advance(self, tok_id: int) -> bool:
        """Step the cursor on an emitted token. False = the token has no
        transition (cannot happen when sampling was masked by this
        guide's row; defensively treated as a dead end by callers)."""
        nxt = int(self.dfa.trans[self.state, tok_id])
        if nxt < 0:
            return False
        self.state = nxt
        return True

    def allows(self, tok_id: int) -> bool:
        row = self.dfa.mask_bits[self.state]
        return bool((row[tok_id >> 3] >> (tok_id & 7)) & 1)

    @property
    def dead_end(self) -> bool:
        """No emittable token at the current state (not even EOS)."""
        return not self.dfa.mask_bits[self.state].any()

    @property
    def accepting(self) -> bool:
        return bool(self.dfa.accepting[self.state])

    def mask_bool(self) -> np.ndarray:
        """Unpacked [V] bool allowed mask at the current state — for the
        host-side first-token sampling (prefill / admission), where the
        logits are already on the host path."""
        return self.dfa.mask_bool(self.state)


def guide_for(spec: dict, tokenizer, config) -> Guide:
    """A serve-plane ``response_format`` body -> fresh :class:`Guide`
    against this engine's tokenizer + config (compile cached at the
    TokenDFA layer; the Guide itself is per-request state)."""
    if tokenizer is None:
        raise ValueError(
            "response_format needs a server-side tokenizer (the grammar "
            "compiles against the vocab's decoded strings)")
    pattern = spec_to_regex(spec)
    vocab = cached_token_strings(tokenizer, config.vocab_size)
    dfa = compile_constraint(pattern, vocab, eos_ids=config.eos_ids())
    return Guide(dfa, spec=spec)
