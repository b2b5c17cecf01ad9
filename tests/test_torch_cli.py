"""Port parity: the CLI (cli.py: run, bench, serve) against the JAX
package's on the CPU.

``run`` prints JAX's one-line JSON: the same keys (and the port's
kv_quantization), text, tokens, steps and acceptance as JAX's CLI given
the same flags (log-probabilities within 1e-4), on the fake model and on
llama-tiny (test_torch_decode_loop.py's pair handed to both packages'
engines), with and without a config file. ``bench`` gives JAX's K-sweep
summary, timings excluded. ``serve`` starts on port 0 in a subprocess
(``python -m llm_inference_lab_tpu_torch.cli``) and
BenchmarkRunner(mode="http") passes against it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import llm_inference_lab_tpu.core.engine as jax_engine_module
import llm_inference_lab_tpu_torch.core.engine as engine_module
from llm_inference_lab_tpu.cli import main as jax_main
from llm_inference_lab_tpu_torch import cli
from llm_inference_lab_tpu_torch.bench.run_bench import BenchmarkRunner
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.server import serving
from test_torch_decode_loop import _pair, one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMINGS = {"latency_ms", "generation_time_ms", "tokens_per_sec", "batch_metrics",
           "device_mem_mb", "device_peak_mb", "mem_rss_mb"}
# Log-probabilities: within 1e-4 (f32 log-softmax in another order).
LOGPROBS = {"token_logprobs", "prompt_logprobs"}
# The port's own values: its device, its controller report, and where the
# weights came from ("fake", "given"; JAX: "unknown", "random").
OWN = {"device", "controller", "weights_source"}
TINY = ["--impl", "hf", "--base-model", "llama-tiny", "--draft-model", "llama-tiny"]


def _last_json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def tiny_weights(monkeypatch):
    """Both CLIs build their engines on llama-tiny's JAX pair (the port's
    through params_from_jax)."""
    target, draft = _pair("llama-tiny")
    tp, dp = params_from_jax(target.params), params_from_jax(draft.params)
    port_engine, jax_engine = engine_module.Engine, jax_engine_module.Engine

    def port(cfg, **kw):
        return port_engine(cfg, target_params=tp, draft_params=dp if cfg.draft_model else None,
                           **kw)

    def jax_(cfg, **kw):
        return jax_engine(cfg, target_model=target,
                          draft_model=draft if cfg.draft_model else None, **kw)

    monkeypatch.setattr(engine_module, "Engine", port)
    monkeypatch.setattr(jax_engine_module, "Engine", jax_)


def _same_run(argv):
    want = _last_json(jax_main, argv)
    got = _last_json(cli.main, argv + ["--device", "cpu"])
    assert set(got) - {"kv_quantization"} == set(want)
    assert "generated_ids" not in got
    if "adaptive" in argv:
        # The host controller's loop runs one step past the last lane's
        # end: JAX's steps count it, the port's state does not
        # (core/engine.py _run_observed).
        want["steps"] -= 1
    for key in set(want) - TIMINGS - LOGPROBS - OWN:
        assert got[key] == want[key], key
    for key in LOGPROBS:
        assert len(got[key]) == len(want[key]) and all(
            (a is None and b is None) or abs(a - b) <= 1e-4 for a, b in zip(got[key], want[key]))
    assert got["generated_tokens"] > 0
    return got


FAKE_RUNS = {
    "fake": ["run", "hello cli", "--impl", "fake", "-k", "2", "--max-tokens", "8"],
    "policy params": ["run", "p", "--impl", "fake", "--policy", "conf_threshold", "--tau", "0.3",
                      "--max-tokens", "6"],
    "baseline": ["run", "p", "--impl", "fake", "--no-draft", "--max-tokens", "6"],
    "adaptive": ["run", "adaptive K here", "--impl", "fake", "--controller", "adaptive",
                 "--target-acceptance", "0.7", "--max-tokens", "12"],
    "specdec.yaml": ["run", "config file prompt", "--config", "configs/specdec.yaml",
                     "--impl", "fake", "--base-model", "fake", "--draft-model", "fake"],
}


@pytest.mark.parametrize("name", list(FAKE_RUNS))
def test_run_fake_equals_jax(name, monkeypatch):
    """JAX's CLI tests' flag sets and configs/specdec.yaml on the fake
    model (the model flags given: JAX's CLI defaults override a file)."""
    monkeypatch.chdir(ROOT)
    got = _same_run(FAKE_RUNS[name])
    if name == "baseline":
        assert got["proposed"] == 0
    if name == "specdec.yaml":
        assert got["dtype"] == "float32"  # the file's


@pytest.mark.parametrize("extra", [[], ["--config", "configs/llama32_int8.yaml"]],
                         ids=["flags", "llama32_int8.yaml"])
def test_run_llama_tiny_equals_jax(extra, tiny_weights, monkeypatch):
    """llama-tiny, f32: K=3 from the flags; or configs/llama32_int8.yaml's
    engine (int8 weights quantized at build, K=4, max_seq_len 512) with the
    models and dtype given as flags."""
    monkeypatch.chdir(ROOT)
    got = _same_run(["run", "tiny cli prompt", *TINY, "-k", "3", "--max-tokens", "12",
                     "--dtype", "float32", *extra])
    assert 0 < got["acceptance_rate"] <= 1
    if extra:
        assert got["quantization"] == "int8"


def test_config_file_beneath_flags_and_unknown_keys(tmp_path):
    """The file's values stand over the CLI's defaults, a flag over the
    file; a key the port's config lacks raises, as a flag value the port
    does not take raises through validate."""
    p = tmp_path / "c.yaml"
    p.write_text("implementation: fake\nbase_model: fake\nmax_draft: 3\nmax_new_tokens: 5\n")
    out = _last_json(cli.main, ["run", "p", "--config", str(p), "--device", "cpu"])
    assert (out["impl"], out["base_model"], out["generated_tokens"]) == ("fake", "fake", 5)
    args = cli.build_parser().parse_args(["run", "p", "--config", str(p), "-k", "2", "--no-draft"])
    cfg = cli.build_config(args)
    assert (cfg.max_draft, cfg.max_new_tokens, cfg.draft_model) == (2, 5, None)
    p.write_text("max_draft: 3\nspeculative_lookahead: 2\n")
    with pytest.raises(ValueError, match="are not fields of the port's EngineConfig"):
        cli.main(["run", "p", "--impl", "fake", "--config", str(p), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="walks the tree greedily"):
        cli.main(["run", "p", *TINY, "--draft-mode", "tree", "--policy", "typical",
                  "--device", "cpu"])


def test_run_profile_and_default_device(capsys):
    """--profile prints the profiler's summary on stderr; the CLI runs on
    the card by default and raises without one."""
    assert cli.main(["run", "hi", "--impl", "fake", "--max-tokens", "4", "--profile",
                     "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert summary["enabled"] and summary["step_ms"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["run", "hi", "--impl", "fake"])


def test_bench_equals_jax(tmp_path):
    """bench: JAX's K-sweep summary and records, timings excluded (the
    port's summary adds each K's setup_s), and its files."""
    argv = ["bench", "--impl", "fake", "--base-model", "fake", "--draft-model", "fake",
            "--max-k", "2", "--max-tokens", "6", "--iterations", "1", "--batch-size", "4"]
    want = _last_json(jax_main, argv)
    got = _last_json(cli.main, argv + ["--device", "cpu", "--output-dir", str(tmp_path)])
    assert set(got) == set(want) and got["config"] == want["config"]
    for k, row in want["summary_results"].items():
        mine = got["summary_results"][k]
        assert set(mine) - {"setup_s"} == set(row)
        assert mine["acceptance_rate"] == row["acceptance_rate"] and mine["success_rate"] == 1.0
    strip = lambda d: {k: v for k, v in d.items() if k not in TIMINGS}  # noqa: E731
    assert ([strip(d) for d in got["detailed_results"]]
            == [strip(d) for d in want["detailed_results"]])
    assert sorted(f.rsplit(".", 1)[1] for f in os.listdir(tmp_path))[:2] == ["csv", "json"]


def test_serve_on_port_0_answers_the_http_runner():
    """``python -m llm_inference_lab_tpu_torch.cli serve --port 0`` on the
    fake model: its first line names the URL; BenchmarkRunner(mode="http")
    finds it healthy and every request (completions and chat) succeeds.
    The subprocess is killed however the test ends."""
    cmd = [sys.executable, "-m", "llm_inference_lab_tpu_torch.cli", "serve", "--impl", "fake",
           "--base-model", "fake", "--draft-model", "fake", "-k", "2", "--max-tokens", "8",
           "--slots", "2", "--port", "0", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        url = json.loads(line)["serving"]
        for chat in (False, True):
            runner = BenchmarkRunner(mode="http", server_url=url, iterations=2)
            runner.http_chat = chat
            out = runner.run(["http prompt one", "two"], max_new_tokens=6)
            assert out["healthy"] and out["success_rate"] == 1.0, out
            assert out["endpoint"] == ("chat/completions" if chat else "completions")
            assert out["tokens_per_sec"]["mean"] > 0
    finally:
        proc.kill()
        proc.communicate(timeout=30)
    assert BenchmarkRunner(mode="http", server_url=url).engine is None


def test_server_main_is_cli_serve(monkeypatch):
    """The server's own entry point takes the CLI's serve flags: one parser
    of the config's fields."""
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 0)
    assert serving.main(["--impl", "fake", "--port", "0"]) == 0
    assert seen == [["serve", "--impl", "fake", "--port", "0"]]
