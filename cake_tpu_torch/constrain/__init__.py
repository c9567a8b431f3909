"""Structured generation: grammar-constrained decoding (copy of
``cake_tpu/constrain``, numpy and stdlib only).

``fsm`` compiles a constraint spec (regex, or JSON Schema lowered to
regex) into a token-level DFA over the tokenizer vocab, cached in process
and on disk under the same content-hash key and file format as the JAX
package's, so a DFA cached by either package loads in the other;
``guide`` holds the per-stream host-side DFA cursor the engines advance
between decode steps. The mask itself is applied on the device by the
sampler (``ops/sampling.py``), from a packed bitmask table the engines
upload once per guide.
"""

from cake_tpu_torch.constrain.fsm import (  # noqa: F401
    RegexError,
    TokenDFA,
    build_token_dfa,
    compile_constraint,
    json_schema_to_regex,
    spec_to_regex,
    token_strings,
)
from cake_tpu_torch.constrain.guide import Guide, guide_for  # noqa: F401
