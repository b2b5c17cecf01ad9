"""Port parity: the host utilities (utils/sequence.py, validation.py,
determinism.py, tokenizer.py) and config.py's load_config, override
and EnvFlags fields, against the JAX package on the CPU.

Sequences, clamped ids, counts and config fields are compared exactly on
inputs made from a seed with numpy.
"""

import dataclasses
import glob
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_lab_tpu import config as jax_config
from llm_inference_lab_tpu.utils import determinism as jdet
from llm_inference_lab_tpu.utils import sequence as jseq
from llm_inference_lab_tpu.utils import tokenizer as jtok
from llm_inference_lab_tpu.utils import validation as jval
from llm_inference_lab_tpu_torch import config
from llm_inference_lab_tpu_torch.utils import determinism, sequence, tokenizer, validation
from test_torch_decode_loop import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _ragged(seed, n, max_len, empty=False):
    rng = np.random.default_rng(seed)
    lo = 0 if empty else 1
    return [rng.integers(0, 500, rng.integers(lo, max_len + 1)).tolist() for _ in range(n)]


@pytest.mark.parametrize("seed,n,max_len,multiple,pad_id", [
    (0, 5, 9, 1, 0), (1, 7, 40, 32, 0), (2, 1, 1, 1, 3), (3, 6, 17, 8, -1), (4, 4, 5, 1, 0)])
def test_sequence_helpers_equal_jax(seed, n, max_len, multiple, pad_id):
    """pad/unpad, the mask, the position ids and the length groups: the
    same arrays (values and dtypes) as JAX's on ragged ids from a seed,
    empty sequences among them."""
    seqs = _ragged(seed, n, max_len, empty=seed % 2 == 0)
    tokens, lens = sequence.pad_sequences(seqs, pad_id=pad_id, multiple=multiple)
    jtokens, jlens = jseq.pad_sequences(seqs, pad_id=pad_id, multiple=multiple)
    for got, want in ((tokens, jtokens), (lens, jlens)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sequence.unpad_sequences(tokens, lens) == jseq.unpad_sequences(jtokens, jlens) == seqs
    for fn in ("attention_mask", "position_ids"):
        for padded in (tokens.shape[1], tokens.shape[1] + 3):
            got, want = getattr(sequence, fn)(lens, padded), getattr(jseq, fn)(jlens, padded)
            assert got.dtype == want.dtype and np.array_equal(got, want), fn
    lengths = [len(s) for s in seqs]
    for group, bucket in ((1, 1), (2, 1), (3, 4), (len(seqs) + 1, 8)):
        assert (sequence.group_by_length(lengths, group, bucket)
                == jseq.group_by_length(lengths, group, bucket))


def test_pad_edges_equal_jax():
    """JAX's edge cases (tests/test_sequence_utils.py): one id, one empty
    sequence, no sequence."""
    for seqs in ([[7]], [[]], []):
        got, want = sequence.pad_sequences(seqs), jseq.pad_sequences(seqs)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))


@pytest.mark.parametrize("vocab", [1, 7, 256, 128256])
def test_validate_and_clamp_equal_jax(vocab):
    """Clamped ids and the count of invalid ids equal JAX's, on the tensor's
    device (a tensor, no host read); shared_vocab_size is min."""
    rng = np.random.default_rng(vocab)
    ids = rng.integers(-5, vocab + 5, (3, 11)).astype(np.int32)
    got, bad = validation.validate_and_clamp_tokens(torch.from_numpy(ids), vocab)
    want, jbad = jval.validate_and_clamp_tokens(jnp.asarray(ids), vocab)
    assert isinstance(bad, torch.Tensor) and bad.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want)) and int(bad) == int(jbad)
    assert validation.shared_vocab_size(vocab, 300) == jval.shared_vocab_size(vocab, 300)


def test_ensure_deterministic_seeds_like_jax():
    """The host RNGs are seeded as JAX's (python, numpy: the same draws),
    torch's too, and the returned generator on the device draws the same
    numbers for the same seed; the pin turns TF32 off; set_deterministic_mode
    takes JAX's arguments; CUDA without a card raises."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        jdet.ensure_deterministic(123)
        want = (random.random(), np.random.rand())
        g = determinism.ensure_deterministic(123, pin_matmul_precision=True, device="cpu")
        assert (random.random(), np.random.rand()) == want
        assert os.environ["PYTHONHASHSEED"] == "123"
        assert isinstance(g, torch.Generator) and g.device.type == "cpu"
        assert torch.equal(torch.randn(4, generator=g),
                           torch.randn(4, generator=torch.Generator().manual_seed(123)))
        assert torch.equal(torch.randn(2), torch.randn(2, generator=torch.Generator()
                                                       .manual_seed(123)))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        for enabled in (True, False):
            g = determinism.set_deterministic_mode(enabled, seed=5, device="cpu")
            assert torch.equal(torch.rand(3, generator=g),
                               torch.rand(3, generator=torch.Generator().manual_seed(5)))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                determinism.ensure_deterministic(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("name,impl", [("fake", "fake"), ("llama-3.2-3b", "hf"),
                                       ("gpt2", "hf")])
def test_get_tokenizer_is_jax_offline_tokenizer(name, impl):
    """get_tokenizer gives the ByteTokenizer for every name; its ids and
    text equal JAX's ByteTokenizer's (JAX's offline fallback), and
    check_tokenizer_compat equals JAX's."""
    tok = tokenizer.get_tokenizer(name, impl)
    want = jtok.ByteTokenizer()
    text = "héllo, wörld ✓ " + name
    assert isinstance(tok, tokenizer.ByteTokenizer)
    assert tok.encode(text) == want.encode(text) and tok.eos_token_id == want.eos_token_id
    assert tok.decode(tok.encode(text)) == want.decode(want.encode(text)) == text
    for other in (tokenizer.ByteTokenizer(), tokenizer.ByteTokenizer(300)):
        assert (tokenizer.check_tokenizer_compat(tok, other)
                == jtok.check_tokenizer_compat(want, jtok.ByteTokenizer(other.vocab_size)))


def _shared_fields(cfg, jcfg):
    names = {f.name for f in dataclasses.fields(cfg)} & {f.name for f in dataclasses.fields(jcfg)}
    return ({n: getattr(cfg, n) for n in names}, {n: getattr(jcfg, n) for n in names})


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_equals_jax(path):
    """Every configs/*.yaml loads to JAX's values on every field the two
    configs share (none of its keys is outside the port's), with and
    without overrides (None ones skipped)."""
    over = dict(max_draft=2, seed=None, policy="typical", max_new_tokens=None)
    for kw in ({}, over):
        got, want = _shared_fields(config.load_config(path, **kw),
                                   jax_config.load_config(path, **kw))
        assert got == want


def test_load_config_layers_and_unknown_keys(tmp_path):
    """defaults <- file <- overrides; a key the port lacks raises (JAX drops
    it); override skips None values, as JAX's."""
    p = tmp_path / "c.yaml"
    p.write_text("max_draft: 3\nmax_new_tokens: 5\ndraft_model: null\n")
    cfg = config.load_config(str(p), defaults=dict(max_draft=9, seed=4, base_model="fake"),
                             max_new_tokens=7, policy=None)
    assert (cfg.max_draft, cfg.max_new_tokens, cfg.seed, cfg.base_model, cfg.draft_model) == (
        3, 7, 4, "fake", None)
    p.write_text("max_draft: 3\nspeculative_lookahead: 5\n")
    with pytest.raises(ValueError, match=r"\['speculative_lookahead'\] are not fields"):
        config.load_config(str(p))
    assert jax_config.load_config(str(p)).max_draft == 3  # JAX drops the key
    kw = dict(max_draft=None, temperature=0.5, draft_model=None, seed=3)
    got, want = _shared_fields(config.EngineConfig().override(**kw),
                               jax_config.EngineConfig().override(**kw))
    assert got["temperature"] == want["temperature"] == 0.5 and got["seed"] == 3
    assert got["draft_model"] == config.EngineConfig().draft_model  # None skipped


def test_env_flags_carry_jax_sweep_flags():
    """EnvFlags has JAX's dry_run and batch_size with JAX's defaults (the
    port's callers pass them: it reads no environment variable)."""
    want = jax_config.EnvFlags()
    flags = config.EnvFlags()
    assert (flags.dry_run, flags.batch_size) == (want.dry_run, want.batch_size)
    assert not hasattr(config.EnvFlags, "from_env")
