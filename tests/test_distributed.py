"""True multi-process distributed execution (2 controllers over a local
coordinator -- the CPU stand-in for multi-host DCN, SURVEY.md section 5).

Each worker is a separate OS process with 4 virtual CPU devices; together
they form one 8-device global mesh.  The tiled pipeline runs globally
sharded and every process validates its addressable shards against the
single-device pipeline.  This exercises `jax.distributed.initialize`,
`global_mesh`, cross-process shard_map dispatch, and
`process_local_batch` -- the paths the in-process virtual-mesh tests
cannot reach.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_tiled_upscale():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    n_proc = 2

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(n_proc), str(rank)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(n_proc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "OK" in out, f"rank {rank} no OK:\n{out}"
        # the dp/sp train_step across the process boundary must have run
        # and matched the single-process twin
        assert "OK-TRAIN" in out, f"rank {rank} no OK-TRAIN:\n{out}"
