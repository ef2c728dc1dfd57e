"""`cli complete`, the port's general-completion entry point, on the CPU held
against the JAX package's: the same config (a TINY f32 model from one HF
safetensors checkpoint both packages load, the byte tokenizer, temperature
0, prefill buckets of 32 and 64 tokens), the same prompt, the same text on
stdout (exact), for a prompt within the largest bucket and for one past it
(its head installed through set_prefix's chunked path, its tail generated
through the fused runtime). `--spec` (or llm.spec_enabled, either arm)
prints the same text through the speculative decoder.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch.engine import engine as tengine
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.observability import spans

MODEL = "tiny-f32-complete"  # TINY in f32: the two packages' greedy tokens agree
SHORT = "Schedule pod web-1 on the least loaded node."
LONG = ("Cluster state: " + ", ".join(f"node-{i} cpu={10 + 7 * i}% mem={20 + 3 * i}%"
                                      for i in range(6)) + ". Which node?")


@pytest.fixture(autouse=True)
def _tiny_f32(monkeypatch):
    monkeypatch.setitem(jconfigs._REGISTRY, MODEL,
                        dataclasses.replace(jconfigs.TINY, name=MODEL, dtype=jnp.float32))
    monkeypatch.setitem(tconfigs._REGISTRY, MODEL,
                        dataclasses.replace(tconfigs.TINY, name=MODEL, dtype=torch.float32))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    from tests.test_torch_cli import _hf_checkpoint

    root = tmp_path_factory.mktemp("complete")
    ckpt = root / "ckpt"
    ckpt.mkdir()
    _hf_checkpoint(ckpt)
    path = root / "config.yaml"
    path.write_text(
        "llm:\n"
        f"  model: {MODEL}\n"
        f"  checkpoint_path: {ckpt}\n"
        "  temperature: 0.0\n"
        "  page_size: 16\n"
        "  prefill_buckets: [32, 64]\n"
        "  compile_cache_dir: null\n"
        "observability:\n"
        "  profiler: false\n"
    )
    return path


def _complete(main, config, prompt, capsys, *extra):
    assert main(["--config", str(config), "complete", "--prompt", prompt,
                 "--max-new-tokens", "24", *extra]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("prompt", [SHORT, LONG], ids=["within-bucket", "past-bucket"])
def test_complete_prints_the_jax_text(config_file, prompt, capsys, monkeypatch):
    assert len(LONG.encode()) > 64 >= len(SHORT.encode())
    want = _complete(jcli.main, config_file, prompt, capsys)
    chunked = []
    real = tengine.InferenceEngine._prefill_prefix_chunked

    def spy(self, *args, **kw):
        chunked.append(len(args[0]))
        return real(self, *args, **kw)

    monkeypatch.setattr(tengine.InferenceEngine, "_prefill_prefix_chunked", spy)
    fused = []
    real_fused = tengine.InferenceEngine.decode_fused

    def fused_spy(self):
        fused.append(self.stats["fused_chunks"])
        return real_fused(self)

    monkeypatch.setattr(tengine.InferenceEngine, "decode_fused", fused_spy)
    got = _complete(cli.main, config_file, prompt, capsys, "--device", "cpu")
    assert got == want and got.strip()
    assert fused  # generate() decoded through the fused runtime
    assert chunked == ([len(LONG.encode()) - 64] if prompt is LONG else [])
    # the completion trace in the port's flight recorder
    (trace,) = [t for t in spans.flight.list(n=None) if t["name"] == "completion"][-1:]
    assert 1 <= trace["meta"]["generated_tokens"] <= 24
    root = spans.flight.get(trace["trace_id"])["spans"][0]
    assert root["attrs"]["prompt_tokens"] == len(prompt.encode())


def test_spec_raises_naming_its_roadmap_item(config_file, monkeypatch, capsys):
    """Speculative decoding is ported: `complete --spec` (and
    llm.spec_enabled) decodes through the decoder the backend attaches,
    greedy through the config, and prints the text of the same command
    without --spec and of the JAX package's `complete --spec`."""
    from k8s_llm_scheduler_tpu_torch.spec import SpeculativeDecoder

    want = _complete(jcli.main, config_file, SHORT, capsys, "--spec")
    plain = _complete(cli.main, config_file, SHORT, capsys, "--device", "cpu")
    runs = []
    real = SpeculativeDecoder.generate

    def spy(self, *args, **kw):
        runs.append(self.arm)
        return real(self, *args, **kw)

    monkeypatch.setattr(SpeculativeDecoder, "generate", spy)
    got = _complete(cli.main, config_file, SHORT, capsys, "--spec", "--device", "cpu")
    assert got == plain == want and got.strip()
    assert runs == ["draft"]
    (trace,) = [t for t in spans.flight.list(n=None) if t["name"] == "completion"][-1:]
    assert spans.flight.get(trace["trace_id"])["spans"][0]["attrs"]["spec"] is True
    monkeypatch.setenv("SPEC_ENABLED", "true")
    monkeypatch.setenv("SPEC_ARM", "hidden")
    assert _complete(cli.main, config_file, SHORT, capsys, "--device", "cpu") == plain
    assert runs == ["draft", "hidden"]
