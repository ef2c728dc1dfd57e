"""The port's tokenizers held against the JAX package's on the CPU: the
same text gives the same ids, pad and eos from the byte and numeric
builtins, from `build_builtin_tokenizer` (which may widen the model's
vocab), and from `HFTokenizerAdapter` over the BPE fixture (the port reads
its own copy under k8s_llm_scheduler_tpu_torch/assets/bpe4k, byte for byte
the JAX package's)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from k8s_llm_scheduler_tpu.engine import tokenizer as jtok
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu_torch.core.prompt import PromptEngine, pod_suffix
from k8s_llm_scheduler_tpu_torch.engine import tokenizer as ttok
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.testing import (
    cap_torch_threads,
    fixture_pods,
    synthetic_nodes,
)

cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
J_FIXTURE = REPO / "k8s_llm_scheduler_tpu" / "assets" / "bpe4k"
T_FIXTURE = REPO / "k8s_llm_scheduler_tpu_torch" / "assets" / "bpe4k"


def _texts():
    """Decision prompts' parts plus text made from a seed: numbers with and
    without leading zeros, long digit runs, punctuation, UTF-8."""
    rng = np.random.default_rng(11)
    engine = PromptEngine()
    nodes = synthetic_nodes(6)
    out = [engine.system_prompt, engine.cluster_part(nodes),
           *(pod_suffix(p) for p in fixture_pods(4)),
           "007 0 12 999 1000 123456 4.50 -3 x9y", "naïve – café ✓ 日本", ""]
    for _ in range(6):
        parts = [str(int(v)) if k % 3 else "node-" + str(int(v))
                 for k, v in enumerate(rng.integers(0, 5000, size=12))]
        out.append(" ".join(parts))
    return out


TEXTS = _texts()


@pytest.mark.parametrize("name", ["byte", "numeric"])
@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_builtin_ids_equal_the_jax_ones(name, i):
    tt, _ = ttok.build_builtin_tokenizer(name, tconfigs.TINY)
    jt, _ = jtok.build_builtin_tokenizer(name, jconfigs.TINY)
    text = TEXTS[i]
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    if name == "numeric" or "�" not in text:
        assert tt.decode(tt.encode(text)) == text
    assert (tt.pad_id, tt.eos_id, tt.vocab_size) == (jt.pad_id, jt.eos_id, jt.vocab_size)


@pytest.mark.parametrize("name", ["byte", "numeric"])
def test_chat_prompt_parts_equal_the_jax_ones(name):
    tt, _ = ttok.build_builtin_tokenizer(name, tconfigs.TINY)
    jt, _ = jtok.build_builtin_tokenizer(name, jconfigs.TINY)
    engine = PromptEngine()
    args = (engine.system_prompt, engine.cluster_part(synthetic_nodes(5)),
            pod_suffix(fixture_pods(1)[0]))
    assert tt.chat_prompt_parts(*args) == jt.chat_prompt_parts(*args)
    assert tt.chat_prompt(args[0], args[1]) == jt.chat_prompt(args[0], args[1])


@pytest.mark.parametrize("model", ["tiny", "llama-3.1-8b-instruct"])
@pytest.mark.parametrize("name", ["byte", "numeric"])
def test_build_builtin_tokenizer_widens_the_vocab_as_the_jax_one(model, name):
    tt, tcfg = ttok.build_builtin_tokenizer(name, tconfigs.get_config(model))
    jt, jcfg = jtok.build_builtin_tokenizer(name, jconfigs.get_config(model))
    assert tcfg.vocab_size == jcfg.vocab_size == tt.vocab_size == jt.vocab_size
    small = dataclasses.replace(tconfigs.TINY, vocab_size=256)
    assert ttok.build_builtin_tokenizer("byte", small)[1].vocab_size == 512
    with pytest.raises(ValueError, match="unknown tokenizer"):
        ttok.build_builtin_tokenizer("sentencepiece", tconfigs.TINY)


def test_the_bpe_fixture_is_a_copy():
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (T_FIXTURE / name).read_bytes() == (J_FIXTURE / name).read_bytes()


@pytest.fixture(scope="module")
def adapters():
    pytest.importorskip("transformers")
    return ttok.HFTokenizerAdapter(str(T_FIXTURE)), jtok.HFTokenizerAdapter(str(J_FIXTURE))


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_hf_adapter_ids_equal_the_jax_ones(adapters, i):
    tt, jt = adapters
    text = TEXTS[i]
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text)) == text


def test_hf_adapter_sentinels_and_prompt_parts_equal_the_jax_ones(adapters):
    tt, jt = adapters
    assert (tt.pad_id, tt.eos_id, tt.vocab_size) == (jt.pad_id, jt.eos_id, jt.vocab_size)
    assert tt._pick_pad_sentinel() == jt._pick_pad_sentinel() == 0
    engine = PromptEngine()
    args = (engine.system_prompt, engine.cluster_part(synthetic_nodes(5)),
            pod_suffix(fixture_pods(1)[0]))
    pfx, sfx = tt.chat_prompt_parts(*args)
    assert pfx and sfx and (pfx, sfx) == jt.chat_prompt_parts(*args)
    assert tt.chat_prompt(args[0], args[1]) == jt.chat_prompt(args[0], args[1])
