"""Port parity: Engine.embed and the server's /v1/embeddings against the JAX
package on the CPU.

Weights: test_torch_decode_loop.py's llama-tiny (f32, projections x10,
jittered norms) carried over with convert.params_from_jax. Both engines run
one prefill-shaped forward of the target and pool its final (post-norm)
hidden states in f32; the two forwards sum the same f32 products in other
orders, so an embedding is held to JAX's within EMB_TOL of its largest
element (normalized rows: of 1). A text alone against its row of a batch:
the batch pads it to another length and runs the products at another M,
so within the same tolerance, not bit for bit.
"""

import base64

import numpy as np
import pytest

from llm_inference_lab_tpu.config import EngineConfig as JaxEngineConfig
from llm_inference_lab_tpu.core.engine import Engine as JaxEngine
from llm_inference_lab_tpu_torch.config import EngineConfig
from llm_inference_lab_tpu_torch.convert import params_from_jax
from llm_inference_lab_tpu_torch.core.engine import Engine
from llm_inference_lab_tpu_torch.server import InferenceServer
from test_torch_decode_loop import _jax_model, one_thread  # noqa: F401
from test_torch_server import _error, _post

EMB_TOL = 2e-5  # of the largest |element| of a row
CFG = dict(base_model="llama-tiny", draft_model=None, max_new_tokens=8, max_seq_len=256,
           dtype="float32")
TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog " * 3, "x",
         "embeddings of three lengths"]


@pytest.fixture(scope="module")
def engines():
    target = _jax_model("llama-tiny", 1)
    jeng = JaxEngine(JaxEngineConfig(implementation="hf", **CFG), target_model=target)
    eng = Engine(EngineConfig(**CFG), device="cpu", target_params=params_from_jax(target.params))
    return jeng, eng


def _close(got, want):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= EMB_TOL * scale), float(
        (np.abs(got - want) / scale).max())


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embed_equals_jax(engines, pooling, normalize):
    """f32 [B, D] rows within EMB_TOL of JAX's, the same prompt token count;
    normalized rows have norm 1."""
    jeng, eng = engines
    want, jn = jeng.embed(TEXTS, pooling=pooling, normalize=normalize)
    got, n = eng.embed(TEXTS, pooling=pooling, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(TEXTS), 64)
    assert n == jn
    _close(got, np.asarray(want))
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_embed_batch_independent_and_deterministic(engines):
    """Each text alone gives its row of the batch within EMB_TOL; a repeat
    gives the same bits; mean and last pooling differ."""
    _, eng = engines
    batch, _ = eng.embed(TEXTS)
    for i, text in enumerate(TEXTS):
        alone, _ = eng.embed([text])
        _close(alone[0], batch[i])
    assert np.array_equal(eng.embed(TEXTS)[0], batch)
    assert not np.allclose(eng.embed(TEXTS, pooling="last")[0], batch, atol=1e-3)


def test_embed_refuses_unknown_pooling(engines):
    _, eng = engines
    with pytest.raises(ValueError, match="pooling must be 'mean' or 'last', got 'max'"):
        eng.embed(["x"], pooling="max")


@pytest.fixture(scope="module")
def embed_server(engines):
    srv = InferenceServer(engines[1], n_slots=2, port=0)
    srv.start()
    yield srv
    srv.stop()


def test_server_embeddings_endpoint(embed_server, engines):
    """/v1/embeddings: a string or a list; float and base64 (little-endian
    f32) give Engine.embed's vectors exactly; the usage counts the prompt
    tokens; pooling "last" is served; completions still run beside it."""
    _, eng = engines
    want, n = eng.embed(TEXTS)
    out = _post(embed_server, "/v1/embeddings", {"input": TEXTS})
    assert out["object"] == "list" and out["model"] == "llama-tiny"
    assert [d["index"] for d in out["data"]] == list(range(len(TEXTS)))
    floats = np.array([d["embedding"] for d in out["data"]], np.float32)
    assert np.array_equal(floats, want)
    b64 = _post(embed_server, "/v1/embeddings", {"input": TEXTS, "encoding_format": "base64"})
    dec = np.stack([np.frombuffer(base64.b64decode(d["embedding"]), "<f4") for d in b64["data"]])
    assert np.array_equal(dec, want)
    assert out["usage"] == {"prompt_tokens": n, "total_tokens": n}
    one = _post(embed_server, "/v1/embeddings", {"input": TEXTS[0], "pooling": "last"})
    assert np.array_equal(np.array(one["data"][0]["embedding"], np.float32),
                          eng.embed(TEXTS[:1], pooling="last")[0][0])
    done = _post(embed_server, "/v1/completions", {"prompt": "still serving", "max_tokens": 3})
    assert done["usage"]["completion_tokens"] == 3


BAD = [({"input": 5}, "input must be a string or list of strings"),
       ({"input": ["a", 3]}, "input must be a string or list of strings"),
       ({"input": []}, "input must be a string or list of strings"),
       ({"input": ["a"] * 65}, "at most 64 inputs"),
       ({"input": "a", "encoding_format": "int8"}, "unsupported encoding_format 'int8'"),
       ({"input": "a", "pooling": "max"}, "unsupported pooling 'max'")]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_server_embeddings_400s(embed_server, i):
    """JAX's 400s, with its messages."""
    body, words = BAD[i]
    assert _error(embed_server, "/v1/embeddings", body) == (400, words)
