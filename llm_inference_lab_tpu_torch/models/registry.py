"""Model registry: name -> family (port of llm_inference_lab_tpu/models/
registry.py get_model: the eight families in JAX's order, and the fake
test model). A name is matched after the same lower-casing and hub-prefix
stripping as in JAX."""

from __future__ import annotations

from llm_inference_lab_tpu_torch.models import gemma, gpt2, llama, mistral, mixtral, opt, phi3, qwen2
from llm_inference_lab_tpu_torch.models.base import Model
from llm_inference_lab_tpu_torch.models.fake import make_fake_model

FAMILIES = ((gpt2.GPT2_CONFIGS, gpt2.create), (llama.LLAMA_CONFIGS, llama.create),
            (opt.OPT_CONFIGS, opt.create), (qwen2.QWEN2_CONFIGS, qwen2.create),
            (mistral.MISTRAL_CONFIGS, mistral.create), (mixtral.MIXTRAL_CONFIGS, mixtral.create),
            (gemma.GEMMA_CONFIGS, gemma.create), (phi3.PHI3_CONFIGS, phi3.create))
# The fake models by name: the target, and the draft the engine pairs with it
# (JAX core/engine.py: a draft that misses 15% of the target's predictions).
FAKE_MODELS = {"fake": {}, "fake-draft": {"miss_permille": 150}}
_PREFIXES = ("meta-llama/", "openai-community/", "facebook/", "qwen/", "mistralai/", "google/",
             "microsoft/")


def model_key(name: str) -> str:
    key = name.lower()
    for prefix in _PREFIXES:
        key = key.replace(prefix, "")
    return key


def create(name: str, implementation: str = "hf", **kw) -> Model:
    """The model `name` (e.g. "qwen2.5-7b" or "Qwen/Qwen2.5-7B"): the
    keywords of factory.create_family_model. implementation="fake", or a
    name of FAKE_MODELS, gives the fake model under that name (no weights:
    the keywords are not read). Raises ValueError for a name no family
    knows."""
    if implementation == "fake" or name in FAKE_MODELS:
        return make_fake_model(name=name, **FAKE_MODELS.get(name, {}))
    key = model_key(name)
    for configs, family_create in FAMILIES:
        if key in configs:
            return family_create(key, **kw)
    known = sorted(k for configs, _ in FAMILIES for k in configs)
    raise ValueError(f"unknown model {name!r}; known: {known}")
