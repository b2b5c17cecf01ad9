"""Grammar-constrained decoding (OpenAI ``response_format``, ``guided_regex``
and forced tool calls).

Port of llm_inference_lab_tpu/constrain/: the host compilers are copies of
JAX's (jsonfsm, regex, schema, tools: numpy, no torch), and runtime.py
applies their tables on the device in torch. JSON is not a regular
language, so the generic grammar keeps a pushdown: a ~37-state char-level
lexer plus an explicit per-slot nesting stack in the decode state. A
one-time host compilation walks every vocab token through the char
automaton from every lexer state and records its stack effect; at decode
time a token's validity is two gathers and a few compares, and the chosen
token's transition a small masked stack update.
"""

from llm_inference_lab_tpu_torch.constrain.jsonfsm import (  # noqa: F401
    CharAutomaton,
    TokenTables,
    compile_token_tables,
    json_char_automaton,
    token_bytes_of,
)
from llm_inference_lab_tpu_torch.constrain.tools import (  # noqa: F401
    build_tools_automaton,
    normalize_tools,
)
