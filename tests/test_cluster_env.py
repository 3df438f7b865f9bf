"""Scheduler-environment derivation for distributed launches (the
reference's runDisco-MPI-SLURM.sh:214 / runDisco-MPI-ALPS.sh launcher
equivalents)."""
import pytest

from disco_tpu.dist.multiproc import (derive_cluster_env, derive_local_rank,
                                     first_slurm_host)


def test_first_slurm_host():
    assert first_slurm_host("tpu003") == "tpu003"
    assert first_slurm_host("tpu[003-006,010]") == "tpu003"
    assert first_slurm_host("n[17,19-22],m01") == "n17"
    assert first_slurm_host("a7,b[1-2]") == "a7"


def test_slurm_env():
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
           "SLURM_JOB_NODELIST": "tpu[004-011]"}
    coord, n, pid = derive_cluster_env(env)
    assert (coord, n, pid) == ("tpu004:8476", 8, 3)
    # step-scoped vars win; explicit coordinator/port override
    env.update({"SLURM_STEP_NUM_TASKS": "4",
                "SLURM_STEP_NODELIST": "tpu[006-009]",
                "DISCO_TPU_PORT": "9999"})
    coord, n, pid = derive_cluster_env(env)
    assert (coord, n, pid) == ("tpu006:9999", 4, 3)
    env["DISCO_TPU_COORDINATOR"] = "10.0.0.5:1234"
    assert derive_cluster_env(env)[0] == "10.0.0.5:1234"


def test_ompi_env():
    env = {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
           "DISCO_TPU_COORDINATOR": "head:8476"}
    assert derive_cluster_env(env) == ("head:8476", 4, 1)


def test_tpu_pod_passthrough():
    # nothing recognized -> all None so jax.distributed.initialize()
    # applies its own cluster auto-detection
    assert derive_cluster_env({}) == (None, None, None)


@pytest.mark.parametrize("env,want", [
    ({"SLURM_LOCALID": "2", "SLURM_PROCID": "6"}, 2),
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "3", "OMPI_COMM_WORLD_RANK": "7"}, 3),
    ({"SLURM_PROCID": "1"}, None),
])
def test_local_rank(env, want):
    # the per-host rank names the one GPU each process drives
    assert derive_local_rank(env) == want
