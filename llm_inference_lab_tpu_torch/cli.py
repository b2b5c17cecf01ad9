"""CLI: ``specdx-torch run``, ``bench`` and ``serve`` (and ``python -m
llm_inference_lab_tpu_torch.cli``); port of llm_inference_lab_tpu/cli.py.

JAX's flags and defaults, plus ``--device`` (cuda; cpu runs the plain
versions of the kernels), ``--quantized-init`` and ``--kv-quantization``
(EngineConfig fields JAX's CLI leaves to a file), and serve's
``--logprobs-topk``. A value the port does not take raises through the
config's validate. The config is the CLI's defaults <- ``--config``'s file
<- the flags given: JAX applies its defaults over the file too, so that
``--config configs/llama32_int8.yaml`` there runs gpt2 on the fake model;
here the file's values stand unless a flag is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional

# JAX's CLI defaults (cli.py:16-79), as EngineConfig fields: beneath a
# --config file's values.
CLI_DEFAULTS: Dict[str, Any] = dict(
    base_model="gpt2", draft_model="distilgpt2", implementation="fake", max_draft=4,
    policy="longest_prefix", controller="fixed", draft_mode="vanilla", max_new_tokens=64,
    temperature=1.0, top_p=1.0, top_k=0, min_p=0.0, repetition_penalty=1.0,
    presence_penalty=0.0, frequency_penalty=0.0, greedy=True, embed_bits=8, seed=0)


def _add_common(p: argparse.ArgumentParser) -> None:
    """JAX's flags. Each defaults to None (not given); CLI_DEFAULTS holds
    the defaults they stand for."""
    p.add_argument("--base-model", help="default gpt2")
    p.add_argument("--draft-model", help="default distilgpt2")
    p.add_argument("--no-draft", action="store_true", help="non-speculative baseline")
    p.add_argument("--impl", choices=["fake", "hf"], help="default fake")
    p.add_argument("--max-draft", "-k", type=int, help="default 4")
    p.add_argument(
        "--policy",
        choices=["longest_prefix", "conf_threshold", "topk_agree", "typical", "rejection"],
        help="default longest_prefix",
    )
    p.add_argument("--tau", type=float, default=None, help="conf_threshold tau")
    p.add_argument("--topk-k", type=int, default=None, help="topk_agree k")
    p.add_argument("--typical-p", type=float, default=None, help="typical p")
    p.add_argument("--controller", choices=["fixed", "adaptive"], help="default fixed")
    p.add_argument("--target-acceptance", type=float, default=0.5)
    p.add_argument("--draft-mode", choices=["vanilla", "medusa", "eagle", "tree", "ngram"],
                   help="default vanilla")
    p.add_argument("--max-tokens", type=int, help="default 64")
    p.add_argument("--temperature", type=float, help="default 1.0")
    p.add_argument("--top-p", type=float, help="default 1.0")
    p.add_argument("--top-k", type=int, help="default 0")
    p.add_argument("--min-p", type=float, help="default 0.0")
    p.add_argument("--repetition-penalty", type=float, help="default 1.0")
    p.add_argument("--presence-penalty", type=float, help="default 0.0")
    p.add_argument("--frequency-penalty", type=float, help="default 0.0")
    p.add_argument("--sample", action="store_true", help="sample instead of greedy")
    p.add_argument("--quantization", choices=["int8", "int4"], default=None)
    p.add_argument("--quantize-embed", action="store_true",
                   help="per-row quantized embedding + tied lm_head")
    p.add_argument("--embed-bits", type=int, choices=[8, 4],
                   help="embed/tied-head width with --quantize-embed (default 8; "
                   "4 = EmbedQuant4: half the head weight read)")
    p.add_argument("--quantized-init", action="store_true",
                   help="random init directly in quantized form (with --quantization)")
    p.add_argument("--kv-quantization", choices=["int8"], default=None,
                   help="an int8 KV cache with per-row scales")
    p.add_argument("--dtype", default=None)
    p.add_argument("--seed", type=int, help="default 0")
    p.add_argument("--constrain", choices=["json", "json_object", "regex"], default=None,
                   help="grammar-constrained decoding (OpenAI response_format / guided "
                        "regex; serving: per-request opt-in)")
    p.add_argument("--constrain-regex", default=None, metavar="PATTERN",
                   help="the pattern for --constrain regex (anchored full match)")
    p.add_argument("--tools", default=None, metavar="TOOLS_JSON",
                   help="path to a JSON file with an OpenAI `tools` list; compiles the "
                        "tool-call grammar (serving: tool_choice 'required' / named functions)")
    p.add_argument("--lora", action="append", default=None, metavar="PEFT_DIR",
                   help="HF PEFT adapter directory (repeatable); serving routes the OpenAI "
                        "`model` field to adapters")
    p.add_argument("--admit-chunk", type=int, default=None,
                   help="interleaved admission: prompts longer than this prefill in chunks "
                        "between decode chunks (serving; multiple of the KV bucket)")
    p.add_argument("--per-request-sampling", action="store_true",
                   help="per-request temperature/top_k/top_p/penalties/seed (serving)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card, raising without one) or cpu")


def build_config(args):
    """The EngineConfig of the parsed flags: CLI_DEFAULTS <- the --config
    file <- the flags given."""
    from llm_inference_lab_tpu_torch.config import load_config

    policy_params = {name: value for name, value in
                     (("tau", args.tau), ("k", args.topk_k), ("p", args.typical_p))
                     if value is not None}
    tools = None
    if args.tools:
        with open(args.tools) as f:
            tools = json.load(f)
    flags = dict(
        base_model=args.base_model,
        draft_model=args.draft_model,
        implementation=args.impl,
        max_draft=args.max_draft,
        policy=args.policy,
        policy_params=policy_params or None,
        controller=args.controller,
        controller_params=({"target_acceptance": args.target_acceptance}
                           if args.controller == "adaptive" else None),
        draft_mode=args.draft_mode,
        max_new_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        min_p=args.min_p,
        repetition_penalty=args.repetition_penalty,
        presence_penalty=args.presence_penalty,
        frequency_penalty=args.frequency_penalty,
        greedy=False if args.sample else None,
        quantization=args.quantization,
        quantize_embed=args.quantize_embed or None,
        embed_bits=args.embed_bits,
        quantized_init=args.quantized_init or None,
        kv_quantization=args.kv_quantization,
        dtype=args.dtype,
        seed=args.seed,
        profile=args.profile or None,
        constrain=args.constrain,
        constrain_regex=args.constrain_regex,
        tools=tools,
        lora_paths=args.lora,
        per_request_sampling=args.per_request_sampling or None,
        admit_chunk=args.admit_chunk,
        logprobs_topk=getattr(args, "logprobs_topk", None),
    )
    cfg = load_config(args.config, defaults=CLI_DEFAULTS, **flags)
    if args.no_draft:
        # override() drops None values, so the baseline is set explicitly.
        cfg = dataclasses.replace(cfg, draft_model=None)
    return cfg


def _build_engine(args):
    from llm_inference_lab_tpu_torch.core.engine import Engine

    return Engine(build_config(args), device=args.device)


def cmd_run(args) -> int:
    eng = _build_engine(args)
    result = eng.generate(args.prompt)
    result.pop("generated_ids", None)
    print(json.dumps(result))  # one line of JSON, as JAX's
    if args.profile:
        print(json.dumps(eng.profiler.summary()), file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from llm_inference_lab_tpu_torch.bench.k_sweep import run_k_sweep

    cfg = dataclasses.asdict(build_config(args))
    named = dict(base_model=cfg.pop("base_model"), draft_model=cfg.pop("draft_model"),
                 implementation=cfg.pop("implementation"),
                 max_new_tokens=cfg.pop("max_new_tokens"), policy=cfg.pop("policy"),
                 quantization=cfg.pop("quantization"), seed=cfg.pop("seed"))
    cfg.pop("max_draft")  # the sweep's own
    summary = run_k_sweep(max_k=args.max_k, iterations=args.iterations,
                          batch_size=args.batch_size, output_dir=args.output_dir,
                          device=args.device, **named, **cfg)
    print(json.dumps(summary))
    return 0


def cmd_serve(args) -> int:
    from llm_inference_lab_tpu_torch.server import InferenceServer

    eng = _build_engine(args)
    server = InferenceServer(eng, n_slots=args.slots, host=args.host, port=args.port)
    server.start(block=False)
    print(json.dumps({"serving": f"http://{server.host}:{server.port}",
                      "model": eng.config.base_model, "slots": args.slots}), flush=True)
    try:
        while server._worker.is_alive():  # the engine thread ends on a failure
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0 if server.failure is None else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="specdx-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="generate for one prompt")
    runp.add_argument("prompt")
    _add_common(runp)
    runp.set_defaults(fn=cmd_run)

    benchp = sub.add_parser("bench", help="K-sweep benchmark")
    _add_common(benchp)
    benchp.add_argument("--max-k", type=int, default=4)
    benchp.add_argument("--iterations", type=int, default=3)
    benchp.add_argument("--batch-size", type=int, default=0, help="0 = whole suite")
    benchp.add_argument("--output-dir", default=None)
    benchp.set_defaults(fn=cmd_bench)

    servep = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    _add_common(servep)
    servep.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    servep.add_argument("--host", default="127.0.0.1")
    servep.add_argument("--slots", type=int, default=8)
    servep.add_argument("--logprobs-topk", type=int, default=None,
                        help="top-N logprobs a generated token (OpenAI `logprobs: N`)")
    servep.set_defaults(fn=cmd_serve)
    return parser


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
