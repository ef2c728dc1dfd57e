"""The port's decision path held against the JAX package on the CPU: the
copied prompt, tokenizer, grammar, validation and JSON modules; the engine's
greedy decision waves (token for token, TINY in f32, constrained, with the
chunked prefix prefill); and the local backend's choice of node.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu.core import prompt as jprompt
from k8s_llm_scheduler_tpu.core import validation as jvalidation
from k8s_llm_scheduler_tpu.engine import constrained as jconstrained
from k8s_llm_scheduler_tpu.engine.engine import InferenceEngine as JEngine
from k8s_llm_scheduler_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from k8s_llm_scheduler_tpu.models import configs as jconfigs
from k8s_llm_scheduler_tpu.models.llama import init_params as jinit_params
from k8s_llm_scheduler_tpu.utils import json_extract as jjson
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.core import prompt as tprompt
from k8s_llm_scheduler_tpu_torch.core import validation as tvalidation
from k8s_llm_scheduler_tpu_torch.engine import constrained as tconstrained
from k8s_llm_scheduler_tpu_torch.engine.engine import InferenceEngine as TEngine
from k8s_llm_scheduler_tpu_torch.engine.local import (
    LocalLLMBackend,
    build_local_backend,
)
from k8s_llm_scheduler_tpu_torch.engine.tokenizer import ByteTokenizer
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.convert import params_from_jax
from k8s_llm_scheduler_tpu_torch.ops import prefix_attention as tpa

ttesting.cap_torch_threads()

REPO = Path(__file__).resolve().parent.parent
JTINY = dataclasses.replace(jconfigs.TINY, dtype=jnp.float32)
TTINY = dataclasses.replace(tconfigs.TINY, dtype=torch.float32)


def _jax_nodes(n):
    return jtesting.synthetic_cluster(n).get_node_metrics()


@pytest.fixture(scope="module")
def tiny_params():
    jp = jinit_params(jax.random.PRNGKey(0), JTINY)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


# Modules the port copies from the JAX package: (path in both packages,
# the reference's text cut at this marker, or None for all of it).
COPIES = [
    ("types.py", None),
    ("core/prompt.py", None),
    ("core/validation.py", None),
    ("core/cache.py", None),
    ("core/breaker.py", None),
    ("core/fallback.py", None),
    ("utils/json_extract.py", None),
    ("utils/units.py", None),
    ("cluster/interface.py", None),
    ("cluster/fake.py", None),
    ("engine/backend.py", None),
    ("sched/deadline.py", None),
    ("sched/client.py", None),
    ("sched/loop.py", None),
    ("observability/spans.py", None),
    ("observability/trace.py", "\n\n@contextlib.contextmanager\ndef device_trace("),
    ("observability/metrics.py", None),
    ("observability/slo.py", None),
    ("sched/journal.py", None),
    ("sched/recovery.py", None),
]


class TestCopiedModules:
    @pytest.mark.parametrize("path,cut", COPIES, ids=[p for p, _ in COPIES])
    def test_copy_matches_the_reference_text(self, path, cut):
        """A copy is the reference's text with the package name rewritten;
        a module that ports its tail its own way (`cut`: trace.py's
        device_trace over torch.profiler) is compared below its own
        docstring, up to the cut in both."""
        want = (REPO / "k8s_llm_scheduler_tpu" / path).read_text().replace(
            "k8s_llm_scheduler_tpu.", "k8s_llm_scheduler_tpu_torch.")
        got = (REPO / "k8s_llm_scheduler_tpu_torch" / path).read_text()
        if cut is not None:
            assert cut in want and cut in got
            want, got = want[:want.index(cut)], got[:got.index(cut)]
            body = "\nfrom __future__ import annotations\n"
            want, got = want[want.index(body):], got[got.index(body):]
        assert got == want

    @pytest.mark.parametrize("n", [1, 4, 32])
    def test_synthetic_nodes_match_the_jax_fake_cluster(self, n):
        got = [dataclasses.asdict(x) for x in ttesting.synthetic_nodes(n)]
        want = [dataclasses.asdict(x) for x in _jax_nodes(n)]
        assert got == want

    @pytest.mark.parametrize("n", [4, 32])
    def test_prompt_ids_are_byte_identical(self, n):
        jt, tt = JByteTokenizer(), ByteTokenizer()
        jpe, tpe = jprompt.PromptEngine(), tprompt.PromptEngine()
        assert jpe.system_prompt == tpe.system_prompt
        for pod in ttesting.fixture_pods(8):
            want = jt.chat_prompt_parts(
                jpe.system_prompt, jpe.cluster_part(_jax_nodes(n)), jprompt.pod_suffix(pod)
            )
            got = tt.chat_prompt_parts(
                tpe.system_prompt,
                tpe.cluster_part(ttesting.synthetic_nodes(n)),
                tprompt.pod_suffix(pod),
            )
            assert got == want
        if n == 32:  # the chip smoke's cluster: a prefix past two chunks
            assert len(got[0]) == 5488

    @pytest.mark.parametrize("style", ["direct", "cot"])
    def test_dfa_tables_are_identical(self, style):
        names = [f"node-{i}" for i in range(12)] + ["gpu-a100-pool-7"]
        jd = jconstrained.build_decision_dfa(
            JByteTokenizer(), names, max_reason_tokens=40, style=style
        )
        td = tconstrained.build_decision_dfa(
            ByteTokenizer(), names, max_reason_tokens=40, style=style
        )
        assert (jd.start_state, jd.done_state, jd.n_states) == (
            td.start_state, td.done_state, td.n_states
        )
        js, ts = jconstrained.sparse_tables(jd), tconstrained.sparse_tables(td)
        for field in ("sp_tokens", "sp_next", "forced", "forced_next"):
            np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
        assert tconstrained.wave_iterations(td, 24) == jconstrained.wave_iterations(jd, 24)

    def test_feasibility_and_json_parsing_agree(self):
        nodes_t = ttesting.synthetic_nodes(6)
        nodes_j = _jax_nodes(6)
        pods = ttesting.fixture_pods(8) + [
            dataclasses.replace(ttesting.fixture_pods(1)[0], node_selector={"zone": "z1"}),
            dataclasses.replace(ttesting.fixture_pods(1)[0], cpu_request=64.0),
        ]
        for pod in pods:
            jpod = jprompt.PodSpec(**dataclasses.asdict(pod))
            got = [n.name for n in tvalidation.feasible_nodes(pod, nodes_t)]
            want = [n.name for n in jvalidation.feasible_nodes(jpod, nodes_j)]
            assert got == want
        for text in (
            '{"selected_node": "node-1", "confidence": 0.7, "reasoning": "x"}',
            'prose ```json\n{"selected_node": "n", "confidence": 1.0, "reasoning": ""}\n```',
            '{"selected_node": "node-2"',
            "no json here",
        ):
            assert tjson_parse(text) == jjson.parse_decision_json(text)


def tjson_parse(text):
    from k8s_llm_scheduler_tpu_torch.utils.json_extract import parse_decision_json

    return parse_decision_json(text)


class TestDecisionWave:
    def test_greedy_tokens_match_jax_with_chunked_prefix(self, tiny_params):
        """TINY in f32, grammar-constrained, greedy: a 4-node cluster prefix
        (1,138 tokens) through the chunked prefill (prefix_chunk 128), then
        one wave of three pods — the same tokens as the JAX engine."""
        jp, tp = tiny_params
        jtok, ttok = JByteTokenizer(), ByteTokenizer()
        pe = tprompt.PromptEngine()
        cluster = pe.cluster_part(ttesting.synthetic_nodes(4))
        prompts = [
            ttok.chat_prompt_parts(pe.system_prompt, cluster, tprompt.pod_suffix(p))
            for p in ttesting.fixture_pods(3)
        ]
        prefix = prompts[0][0]
        suffixes = [s for _, s in prompts]
        names = [f"node-{i}" for i in range(4)]
        common = dict(max_slots=4, prefill_buckets=(128, 256, 512),
                      temperature=0.0, prefix_chunk=128)

        jeng = JEngine(jp, JTINY, jtok, num_pages=16, page_size=64,
                       max_pages_per_seq=8, **common)
        jeng.set_prefix(prefix)
        jeng.set_grammar(jconstrained.build_decision_dfa(jtok, names, max_reason_tokens=12))
        want = jeng.decide_wave(suffixes, max_new_tokens=90)

        teng = TEngine(tp, TTINY, ttok, **common)
        teng.set_prefix(prefix)
        teng.set_grammar(tconstrained.build_decision_dfa(ttok, names, max_reason_tokens=12))
        tpa.reset_launch_counts()
        got = teng.decide_wave(suffixes, max_new_tokens=90)

        assert teng._prefix.k.shape == jeng._prefix.k.shape  # the same headroom
        assert [f.token_ids for f in got] == [f.token_ids for f in want]
        assert all(json.loads(f.text)["selected_node"] in names for f in got)
        assert teng.stats["wave_model_calls"] == jeng.stats["wave_model_calls"]
        assert tpa.flash_prefix_attention_parts.launches == 0  # CPU: plain twins

    def test_lcp_seeded_prefill_matches_a_fresh_one(self, tiny_params):
        _, tp = tiny_params
        rng = np.random.default_rng(0)
        base = [int(t) for t in rng.integers(1, 256, size=300)]
        drifted = base[:250] + [int(t) for t in rng.integers(1, 256, size=40)]
        kw = dict(prefill_buckets=(128, 256), temperature=0.0, prefix_chunk=128)
        seeded = TEngine(tp, TTINY, ByteTokenizer(), **kw)
        seeded.set_prefix(base)
        seeded.set_prefix(drifted)
        assert seeded.stats["prefix_reused_tokens"] == 250
        fresh = TEngine(tp, TTINY, ByteTokenizer(), **kw)
        fresh.set_prefix(drifted)
        torch.testing.assert_close(
            seeded._prefix.k[:, :290], fresh._prefix.k[:, :290], rtol=1e-5, atol=1e-5
        )


class TestBackend:
    def test_picks_the_same_node_as_the_jax_backend(self, tiny_params):
        from k8s_llm_scheduler_tpu.engine.local import (
            LocalLLMBackend as JBackend,
        )

        jp, tp = tiny_params
        pods = ttesting.fixture_pods(2)
        jbackend = JBackend(
            JEngine(jp, JTINY, JByteTokenizer(), num_pages=16, page_size=64,
                    max_pages_per_seq=8, temperature=0.0),
            max_new_tokens=100, packed_admission=False,
            prewarm_idle_delay_s=600.0,
        )
        try:
            want = [
                jbackend.get_scheduling_decision(
                    jprompt.PodSpec(**dataclasses.asdict(p)), _jax_nodes(4)
                )
                for p in pods
            ]
        finally:
            jbackend.close()
        tbackend = LocalLLMBackend(
            TEngine(tp, TTINY, ByteTokenizer(), temperature=0.0), max_new_tokens=100
        )
        try:
            got = [
                tbackend.get_scheduling_decision(p, ttesting.synthetic_nodes(4))
                for p in pods
            ]
            batch = tbackend.get_scheduling_decisions_batch(
                pods, ttesting.synthetic_nodes(4)
            )
        finally:
            tbackend.close()
        assert [d.selected_node for d in got] == [d.selected_node for d in want]
        assert [(d.confidence, d.reasoning) for d in got] == [
            (d.confidence, d.reasoning) for d in want
        ]
        assert [d.selected_node for d in batch] == [d.selected_node for d in got]

    def test_entry_points_default_to_cuda_and_raise_without_it(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_local_backend("tiny")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_local_backend()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_local_backend("tiny", quantize="int8")
        with pytest.raises(ValueError, match="unknown quantization"):
            build_local_backend("tiny", device="cpu", quantize="int4")
        from k8s_llm_scheduler_tpu_torch.engine.kv_cache import PagedKVCache
        from k8s_llm_scheduler_tpu_torch.models.llama import init_params
        from k8s_llm_scheduler_tpu_torch.models.quant import init_params_int8_host

        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params_int8_host(0, tconfigs.TINY)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedKVCache(tconfigs.TINY)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(init_params(tconfigs.TINY), tconfigs.TINY, paged_attn="pallas")

    def test_engine_refuses_unknown_settings(self, tiny_params):
        _, tp = tiny_params
        with pytest.raises(ValueError, match="paged_attn"):
            TEngine(tp, TTINY, paged_attn="xla")
        with pytest.raises(ValueError, match="decode_matmul"):
            TEngine(tp, TTINY, decode_matmul="sparse")
        with pytest.raises(ValueError, match="multiples of page_size"):
            TEngine(tp, TTINY, prefill_buckets=(100,))


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    """Nor yaml, safetensors or transformers: the port imports each only
    where it is used (a config file read, a tokenizer directory loaded)."""
    code = (
        "import sys, json\n"
        "import k8s_llm_scheduler_tpu_torch as p\n"
        "import k8s_llm_scheduler_tpu_torch.engine.local, "
        "k8s_llm_scheduler_tpu_torch.engine.kv_cache, "
        "k8s_llm_scheduler_tpu_torch.engine.admission.chunked, "
        "k8s_llm_scheduler_tpu_torch.engine.admission.packer, "
        "k8s_llm_scheduler_tpu_torch.engine.admission.pinned, "
        "k8s_llm_scheduler_tpu_torch.sched.delta, "
        "k8s_llm_scheduler_tpu_torch.models.convert, "
        "k8s_llm_scheduler_tpu_torch.models.quant, "
        "k8s_llm_scheduler_tpu_torch.ops.paged_attention, "
        "k8s_llm_scheduler_tpu_torch.ops.ragged_matmul, "
        "k8s_llm_scheduler_tpu_torch.testing, "
        "k8s_llm_scheduler_tpu_torch.cluster.fake, "
        "k8s_llm_scheduler_tpu_torch.sched.client, "
        "k8s_llm_scheduler_tpu_torch.sched.loop, "
        "k8s_llm_scheduler_tpu_torch.observability.spans, "
        "k8s_llm_scheduler_tpu_torch.observability.trace, "
        "k8s_llm_scheduler_tpu_torch.config, "
        "k8s_llm_scheduler_tpu_torch.logging_setup, "
        "k8s_llm_scheduler_tpu_torch.cluster.httpapi, "
        "k8s_llm_scheduler_tpu_torch.cluster.kube, "
        "k8s_llm_scheduler_tpu_torch.cluster.wire_fake, "
        "k8s_llm_scheduler_tpu_torch.engine.tokenizer, "
        "k8s_llm_scheduler_tpu_torch.models.loader, "
        "k8s_llm_scheduler_tpu_torch.engine.fused.tables, "
        "k8s_llm_scheduler_tpu_torch.engine.fused.sampler, "
        "k8s_llm_scheduler_tpu_torch.engine.fused.loop, "
        "k8s_llm_scheduler_tpu_torch.engine.persistent.ring, "
        "k8s_llm_scheduler_tpu_torch.engine.persistent.loop, "
        "k8s_llm_scheduler_tpu_torch.engine.persistent.server, "
        "k8s_llm_scheduler_tpu_torch.observability.resident, "
        "k8s_llm_scheduler_tpu_torch.spec, "
        "k8s_llm_scheduler_tpu_torch.spec.decoder, "
        "k8s_llm_scheduler_tpu_torch.spec.draft, "
        "k8s_llm_scheduler_tpu_torch.spec.hidden, "
        "k8s_llm_scheduler_tpu_torch.spec.verify, "
        "k8s_llm_scheduler_tpu_torch.sched.journal, "
        "k8s_llm_scheduler_tpu_torch.sched.recovery, "
        "k8s_llm_scheduler_tpu_torch.observability.profiler, "
        "k8s_llm_scheduler_tpu_torch.observability.sampler, "
        "k8s_llm_scheduler_tpu_torch.observability.metrics, "
        "k8s_llm_scheduler_tpu_torch.observability.slo, "
        "k8s_llm_scheduler_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules"
        " if m in ('jax', 'yaml', 'safetensors', 'transformers')"
        " or m.startswith(('jax.', 'yaml.', 'safetensors.', 'transformers.'))"
        " or m == 'k8s_llm_scheduler_tpu' or m.startswith('k8s_llm_scheduler_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
