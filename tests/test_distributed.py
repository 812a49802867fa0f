"""2-process jax.distributed bring-up test (P5): executes
parallel.mesh.init_distributed for real — two OS processes, a gRPC
coordinator on localhost, 4 virtual CPU devices each — then runs a psum and
one candidate-sharded expansion round over the global 2x4 (hosts x chips)
mesh.  This is the single-machine stand-in for a 2-host deployment
(SURVEY.md section 4 item 4).
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_distributed_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_round():
    port = _free_port()
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, coord, "2", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"PSUM_OK {i}" in out, out
        assert f"ROUND_OK {i}" in out, out
        assert f"PLAN_OK {i}" in out, out
    # both processes agree on the committed tree size
    sizes = {o.split("ROUND_OK")[1].split()[1] for o in outs}
    assert len(sizes) == 1, outs
    # and the FULL update_plan facade commits an identical plan in both
    # processes (reached flag, plan length, node count, plan digest)
    digests = {o.split("PLAN_OK")[1].splitlines()[0].split(maxsplit=1)[1]
               .strip() for o in outs}
    assert len(digests) == 1, outs
    # and the scenario-sharded fleet (P4) agrees across processes on the
    # per-scenario size/goal/state digest
    for i, out in enumerate(outs):
        assert f"FLEET_OK {i}" in out, out
    fdigests = {o.split("FLEET_OK")[1].splitlines()[0].split(maxsplit=1)[1]
                .strip() for o in outs}
    assert len(fdigests) == 1, outs
