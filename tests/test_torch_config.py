"""The port's configuration held against the JAX package's on the CPU: the
same YAML file and env resolve to the same config tree, both
`_backend_kwargs` map it to the same backend settings for every key the
port honours, and every switch of a path the port has not ported yet
raises before any model is built."""

import copy
import logging
import sys

import pytest

from k8s_llm_scheduler_tpu import cli as jcli
from k8s_llm_scheduler_tpu import config as jconfig
from k8s_llm_scheduler_tpu_torch import cli
from k8s_llm_scheduler_tpu_torch import config as tconfig
from k8s_llm_scheduler_tpu_torch.testing import cap_torch_threads, synthetic_cluster

cap_torch_threads()

YAMLS = {
    "empty": "",
    "llm block": "llm:\n  temperature: 0.7\n  max_batch: 4\n  page_size: 64\n"
                 "  prefill_buckets: [128, 256]\n  quantization: int8\n"
                 "  decode_matmul: ragged\n  tokenizer: numeric\n",
    "admission and cache": "admission:\n  packed: false\n  max_pins: 2\n"
                           "cache:\n  enabled: false\n  ttl_seconds: 9\n",
    "scheduler and breaker": "scheduler:\n  name: custom\n  decision_deadline_ms: 250\n"
                             "circuit_breaker:\n  enabled: false\n  timeout: 7\n",
    "repo config.yaml": None,  # the repository's own file
}
ENVS = {
    "none": {},
    "reference names": {"LLM_MODEL": "llama-3.1-8b-instruct", "MAX_RETRIES": "5",
                        "LLM_TIMEOUT": "30"},
    "sampling": {"LLM_TEMPERATURE": "0", "LLM_TOP_K": "40", "LLM_MAX_TOKENS": "390",
                 "LLM_ANSWER_STYLE": "cot", "LLM_MAX_REASON_TOKENS": "256"},
    "admission": {"ADMISSION_PACKED": "false", "ADMISSION_CHUNK_TOKENS": "128",
                  "ADMISSION_DELTA_PROMPTS": "0", "ADMISSION_REPIN_FRACTION": "0.5",
                  "ADMISSION_MAX_PINS": "3"},
    "checkpoint": {"LLM_CHECKPOINT_PATH": "/ckpt", "LLM_TOKENIZER": "numeric",
                   "SCHED_DECISION_DEADLINE_MS": "0", "CACHE_ENABLED": "false"},
    "speculative": {"SPEC_ENABLED": "true", "SPEC_ARM": "hidden", "SPEC_K": "3",
                    "SPEC_DRAFT_MODEL": "small", "SPEC_DISABLE_THRESHOLD": "0.5"},
}


def _yaml_path(tmp_path, name):
    from pathlib import Path

    if YAMLS[name] is None:
        return Path(__file__).resolve().parent.parent / "config.yaml"
    path = tmp_path / "config.yaml"
    path.write_text(YAMLS[name])
    return path


@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("yaml_name", sorted(YAMLS))
def test_load_config_equals_the_jax_one(tmp_path, yaml_name, env):
    path = _yaml_path(tmp_path, yaml_name)
    want = jconfig.load_config(yaml_path=path, env=ENVS[env])
    got = tconfig.load_config(yaml_path=path, env=ENVS[env])
    assert got.data == want.data


@pytest.mark.parametrize("env", sorted(ENVS))
def test_env_alone_equals_the_jax_one(tmp_path, monkeypatch, env):
    """No config.yaml in the working directory: defaults and env only."""
    monkeypatch.chdir(tmp_path)
    want = jconfig.load_config(env=ENVS[env])
    got = tconfig.load_config(env=ENVS[env])
    assert got.data == want.data
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    assert tconfig.ENV_OVERRIDES == jconfig.ENV_OVERRIDES


def test_the_working_directory_config_yaml_is_read(tmp_path, monkeypatch):
    (tmp_path / "config.yaml").write_text("llm:\n  model: tiny\n")
    monkeypatch.chdir(tmp_path)
    assert tconfig.load_config(env={}).get("llm.model") == "tiny"


@pytest.mark.parametrize("env", sorted(ENVS))
@pytest.mark.parametrize("yaml_name", sorted(YAMLS))
def test_backend_kwargs_agree_on_every_key_the_port_honours(tmp_path, yaml_name, env):
    path = _yaml_path(tmp_path, yaml_name)
    want = jcli._backend_kwargs(jconfig.load_config(yaml_path=path, env=ENVS[env]))
    got = cli._backend_kwargs(tconfig.load_config(yaml_path=path, env=ENVS[env]))
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    # the keys the JAX mapping has beyond the port's belong to JAX alone
    # (its mesh and compile cache)
    assert set(want) - set(got) == {"mesh_axes", "compile_cache_dir"}


def test_backend_kwargs_name_build_local_backend_parameters():
    import inspect

    from k8s_llm_scheduler_tpu_torch.engine.local import build_local_backend

    params = inspect.signature(build_local_backend).parameters
    kw = cli._backend_kwargs(tconfig.Config(copy.deepcopy(tconfig.DEFAULTS)))
    assert set(kw) <= set(params)
    # the reference's defaults: sampled at 0.3, packed admission on
    assert params["temperature"].default == 0.3 and kw["temperature"] == 0.3
    assert params["packed_admission"].default is True and kw["packed_admission"] is True
    assert params["top_k"].default == 0


def _cfg(**dotted):
    cfg = tconfig.Config(copy.deepcopy(tconfig.DEFAULTS))
    for key, value in dotted.items():
        node = cfg.data
        *parents, leaf = key.split(".")
        for part in parents:
            node = node[part]
        node[leaf] = value
    return cfg


UNPORTED = [(key, True if key != "distributed.replica_addrs" else ["h:9901"], item)
            for key, _, item in cli.UNPORTED_SWITCHES] + [
    ("llm.mesh", {"dp": 1, "tp": 2}, 9),
    ("llm.mesh", {"dp": 2, "tp": 1}, 9),
    ("fleet.enabled+addrs", None, 9),
]


@pytest.mark.parametrize("key,value,item", UNPORTED,
                         ids=[f"{k}={v}" for k, v, _ in UNPORTED])
def test_each_unported_switch_raises_before_a_model_is_built(monkeypatch, key, value, item):
    from k8s_llm_scheduler_tpu_torch.engine import local

    def no_model(**kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(local, "build_local_backend", no_model)
    if key == "fleet.enabled+addrs":
        cfg, key = _cfg(**{"fleet.enabled": True, "fleet.prefill_addrs": ["h:1"]}), "fleet"
    else:
        cfg = _cfg(**{key: value})
    with pytest.raises(NotImplementedError, match=rf"{key}.*item {item}"):
        cli.check_switches(cfg)
    cluster = synthetic_cluster(2)
    with pytest.raises(NotImplementedError, match=key):
        cli.build_stack(cfg, cluster, device="cpu")
    cluster.close()


def test_defaults_pass_and_warn_for_the_two_switches_on_by_default(caplog):
    """Every switch on by default is ported now, the profiler last: the
    defaults pass without a warning, and so do the operating plane's
    switches (journal, metrics, SLO)."""
    cfg = _cfg()
    with caplog.at_level(logging.WARNING, logger="k8s_llm_scheduler_tpu_torch.cli"):
        cli.check_switches(cfg)
        cli.check_switches(_cfg(**{"durability.enabled": True, "metrics.enabled": True,
                                   "slo.enabled": True}))
    assert caplog.text == ""
    assert not hasattr(cli, "WARNED_SWITCHES")
    assert {key for key, _, _ in cli.UNPORTED_SWITCHES}.isdisjoint(
        {"durability.enabled", "metrics.enabled", "slo.enabled", "observability.profiler"})
    cli.check_switches(_cfg(**{"llm.persistent_loop": True}))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="k8s_llm_scheduler_tpu_torch.cli"):
        cli.check_switches(_cfg(**{"observability.profiler": False, "llm.fused_decode": False}))
    assert caplog.text == ""


def test_a_config_file_without_pyyaml_raises_naming_the_file(tmp_path, monkeypatch):
    path = tmp_path / "sched.yaml"
    path.write_text("llm:\n  model: tiny\n")
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    with pytest.raises(RuntimeError, match="sched.yaml.*PyYAML"):
        tconfig.load_config(yaml_path=path, env={})
    monkeypatch.chdir(tmp_path)
    assert tconfig.load_config(env={}).get("llm.model") == "llama-3.2-1b-instruct"


def test_build_stack_follows_the_config():
    """The stub backend, the cache and the breaker where enabled, the
    deadline's "<= 0 disables", the scheduler's name."""
    from k8s_llm_scheduler_tpu_torch.engine.backend import StubBackend

    cluster = synthetic_cluster(2)
    cfg = _cfg(**{"llm.backend": "stub", "scheduler.name": "s2",
                  "scheduler.decision_deadline_ms": "0", "cache.enabled": False,
                  "observability.profiler": False, "llm.fused_decode": False})
    scheduler, backend = cli.build_stack(cfg, cluster)
    assert isinstance(backend, StubBackend) and scheduler.client.backend is backend
    assert scheduler.client.cache is None and scheduler.client.breaker is not None
    assert scheduler.client.deadline_ms is None
    assert scheduler.scheduler_name == "s2"
    scheduler2, _ = cli.build_stack(_cfg(**{"llm.backend": "stub",
                                            "circuit_breaker.enabled": False,
                                            "scheduler.decision_deadline_ms": 250}), cluster)
    assert scheduler2.client.breaker is None and scheduler2.client.cache is not None
    assert scheduler2.client.deadline_ms == 250.0
    cluster.close()
