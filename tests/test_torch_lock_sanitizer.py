"""The port's runtime lock-order sanitizer (k8s_llm_scheduler_tpu_torch/
testing.py): the JAX module's text, its cases run against the port's copy,
and the d2d prefix-KV plane between two tp=2 groups built and run inside
it (the two groups' drivers are this process: an adopting driver holds its
own group's lock while it copies the other group's blocks, and each group
fills for the other once).

The JAX module's cases (tests/test_lock_sanitizer.py) run unchanged, with
the names they import bound to the port's copies.
"""

import asyncio
import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from k8s_llm_scheduler_tpu import testing as jtesting
from k8s_llm_scheduler_tpu_torch import testing as ttesting
from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend
from k8s_llm_scheduler_tpu_torch.fleet import kvplane as tkv
from k8s_llm_scheduler_tpu_torch.models import configs as tconfigs
from k8s_llm_scheduler_tpu_torch.models.llama import init_params
from k8s_llm_scheduler_tpu_torch.models.loader import save_checkpoint
from k8s_llm_scheduler_tpu_torch.parallel import launch

ttesting.cap_torch_threads()


def _jax_cases():
    """tests/test_lock_sanitizer.py as a module of another name (so that it
    is not collected twice)."""
    path = Path(__file__).with_name("test_lock_sanitizer.py")
    spec = importlib.util.spec_from_file_location("jax_lock_sanitizer_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JCASES = _jax_cases()
CASES = [(cls, name) for cls in sorted(n for n in vars(JCASES) if n.startswith("Test"))
         for name in sorted(vars(getattr(JCASES, cls))) if name.startswith("test_")]
PORTED = ("LockOrderSanitizer", "LockOrderViolation", "async_deadline")

_MICRO = dict(name="lock-sanitizer-micro", vocab_size=512, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=4096, rope_theta=10000.0,
              tie_embeddings=True, dtype=torch.float32)
ENGINE_KW = dict(num_pages=256, page_size=16, max_slots=4, max_pages_per_seq=32,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), chunk_steps=4,
                 temperature=0.0, prefix_chunk=256, admission_chunk_tokens=16)
BACKEND_KW = dict(max_new_tokens=80, packed_admission=False, request_timeout_s=600.0,
                  prewarm_idle_delay_s=600.0, delta_prompts=True)


@pytest.mark.parametrize("name", ["LockOrderViolation", "_SanitizedLock", "LockOrderSanitizer"])
def test_the_sanitizer_is_the_jax_modules_text(name):
    assert inspect.getsource(getattr(ttesting, name)) == inspect.getsource(
        getattr(jtesting, name))


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c}.{n}" for c, n in CASES])
def test_the_jax_modules_case_passes_on_the_ports_copy(cls, name, monkeypatch):
    """One case of tests/test_lock_sanitizer.py, its imports bound to the
    port's sanitizer; its fixture case takes a port sanitizer installed
    around it, as the conftest fixture installs the JAX one."""
    for attr in PORTED:
        monkeypatch.setattr(JCASES, attr, getattr(ttesting, attr))
    case = getattr(getattr(JCASES, cls)(), name)
    if "lock_sanitizer" not in inspect.signature(case).parameters:
        case()
        return
    with ttesting.LockOrderSanitizer() as san:
        case(lock_sanitizer=san)
    san.assert_clean()


def test_two_tp2_groups_fill_and_adopt_d2d_pages_inside_the_sanitizer(tmp_path, monkeypatch):
    """Two tp=2 backends built inside the port's sanitizer share one
    KVPlaneStore with transport d2d, deciding from the event loop: for one
    cluster the first fills and publishes and the second adopts, for
    another the other way round; then the store drops both page sets and
    every rank releases them. No order cycle, no lock held across an
    event-loop hop, and the group locks and export books were tracked."""
    cfg = tconfigs.LlamaConfig(**_MICRO)
    monkeypatch.setitem(tconfigs._REGISTRY, cfg.name, cfg)
    save_checkpoint(tmp_path / "ckpt", init_params(cfg, seed=0, device="cpu"))
    pods, nodes = ttesting.fixture_pods(2), ttesting.synthetic_nodes(4)
    backends = []
    with ttesting.LockOrderSanitizer() as san:
        try:
            for _ in range(2):
                backends.append(build_local_backend(
                    cfg.name, device="cpu", checkpoint_path=str(tmp_path / "ckpt"),
                    mesh_axes={"tp": 2}, **ENGINE_KW, **BACKEND_KW))
            store = tkv.KVPlaneStore()
            for i, backend in enumerate(backends):
                backend.attach_kvplane(store, replica=f"replica-{i}", transport="d2d")

            async def decide():
                first = [await b.get_scheduling_decision_async(pods[0], nodes[:3])
                         for b in backends]
                second = [await b.get_scheduling_decision_async(pods[1], nodes)
                          for b in reversed(backends)]
                return first, second

            decisions = asyncio.run(decide())
            stats = [b.get_stats()["kvplane"] for b in backends]
            store.bump_generation()
            tables = [b.engine.rank_group.on_ranks(launch.export_table) for b in backends]
        finally:
            for backend in backends:
                backend.close()
    assert [(s["publishes"], s["adoptions"]) for s in stats] == [(1, 1), (1, 1)]
    for pair in decisions:
        assert pair[0].selected_node == pair[1].selected_node
    assert tables == [[[], []]] * 2
    seen = set(san.edges) | {b for dst in san.edges.values() for b in dst}
    assert len({site for site in seen if site.startswith("parallel/launch.py")}) >= 2
    san.assert_clean()
