"""The port's ``Config`` (horovod_tpu_torch/config.py) against the JAX
package's (horovod_tpu/config.py): the same fields, defaults and
environment readings, but for a named list of fields the port leaves
out, each with its reason."""

import dataclasses

import pytest

from horovod_tpu.config import Config as JConfig
from horovod_tpu_torch.config import Config as TConfig

# The reference's fields the port has no counterpart of, and why.
LEFT_OUT = {
    # the engine's local tier is dcn_local_size (HOROVOD_DCN_LOCAL_SIZE):
    # HOROVOD_TPU_LOCAL_SIZE is the port launcher's variable, a pinned
    # difference (ROADMAP.md, Queue 3's known differences)
    "tpu_local_size",
    # nothing read it, in the port or in the JAX package; removed when
    # the autotuner was ported
    "autotune_gaussian_process_noise",
}


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_the_config_has_every_field_of_the_reference():
    """Every field of the JAX package's Config is the port's too, with
    the same default, but the named ones; a knob the port forgot to read
    (HOROVOD_HIERARCHICAL_ALLGATHER was one) fails here."""
    ours, theirs = _fields(TConfig), _fields(JConfig)
    assert set(theirs) - set(ours) == LEFT_OUT
    assert not LEFT_OUT & set(ours)
    for name in set(theirs) & set(ours):
        assert ours[name] == theirs[name], name


ENVS = [
    {},
    {"HOROVOD_HIERARCHICAL_ALLGATHER": "1",
     "HOROVOD_HIERARCHICAL_ALLREDUCE": "1", "HOROVOD_FUSION_DONATE": "0"},
    {"HOROVOD_SPARK_START_TIMEOUT": "0",
     "HOROVOD_ELASTIC_DRAIN_SECONDS": "7.5", "HOROVOD_ZERO_STAGE": "9",
     "HOROVOD_GUARD": "1", "HOROVOD_GUARD_BAD_STEPS": "0"},
    {"HOROVOD_SPARK_START_TIMEOUT": "42", "HOROVOD_FUSION_DONATE": "1",
     "HOROVOD_DCN_LOCAL_SIZE": "-3", "HOROVOD_START_TIMEOUT": "bogus"},
    {"HOROVOD_LOG_LEVEL": "debug", "HOROVOD_LOG_HIDE_TIME": "1"},
]


@pytest.mark.parametrize("env", ENVS)
def test_from_env_reads_what_the_reference_reads(monkeypatch, env):
    """The same environment gives both packages the same values, clamps
    included, for every field they share."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = dataclasses.asdict(TConfig.from_env())
    theirs = dataclasses.asdict(JConfig.from_env())
    for name in set(ours) & set(theirs):
        assert ours[name] == theirs[name], name
