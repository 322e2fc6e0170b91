"""Execution over several processes: torch.distributed (gloo) over N ranks.

The port of boda_tpu/parallel/multihost.py. `init_multihost` joins N
processes into one process group (gloo over tcp://<coordinator>, with an
explicit init timeout; NCCL refuses two ranks on one card). The global mesh
is every rank's slots, rank-major (mesh.global_devices): N ranks of L
slots make a mesh of N*L positions, and the mesh forward
(engine/mesh_fwd.py) runs each rank's positions with the collectives of
parallel/mesh.py between ranks, as GSPMD ran one program over every
host's devices.

Mode `mh_test` is the self-check: rank 0 spawns the other ranks running the
same command (the reference's self-spawning IPC test idiom, cs_test_master
rtc_ipc.cc:290-330), all ranks run the same sharded forward (or, with
--train=1, one training step) on a deterministic input, and rank 0 checks
that every rank's output digest matches its own. `--spawn=0` runs one rank
alone, for ranks launched externally. The training step lowers under the
f32 vendor tune (dryrun.TRAIN_TUNE), since the hand kernels B1 and B2 have
no backward.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from datetime import timedelta

from ..core.config import Attr
from ..core.error import RtErr
from ..core.has_main import HasMain, mode

# how long init_process_group waits for every rank (and each collective
# for its peers) before it raises, so a rank that never comes fails the run
INIT_TIMEOUT = timedelta(seconds=300)
# how long rank 0 waits for each spawned rank after its own part
RANK_TIMEOUT_S = 600


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join this process into the global process group (gloo, rank
    `process_id` of `num_processes`, rendezvous at tcp://coordinator)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=INIT_TIMEOUT)


def shutdown_multihost() -> None:
    """Leave the process group (destroy_process_group) if this process is
    in one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_array(sharding, global_np) -> dict:
    """{local mesh position: its shard on its slot's device} of a
    host-replicated numpy array: every process passes the SAME global data
    and fills only its own positions (the multi-host feed idiom)."""
    import numpy as np
    import torch

    from .mesh import shard_of
    mesh = sharding.mesh
    t = torch.from_numpy(np.ascontiguousarray(global_np))
    return {p: shard_of(t, sharding, p).to(mesh.device(p))
            for p in mesh.local_positions()}


def force_local_cpu_devices(n: int) -> None:
    """This run and the processes it spawns on the CPU with n slots per
    process (the multi-chip-without-a-cluster test rig): the CPU ask
    (BODA_TORCH_DEVICE=cpu) and BODA_TORCH_LOCAL_DEVICES=n."""
    from ..core.device import DEVICE_ENV, LOCAL_DEVICES_ENV
    os.environ[DEVICE_ENV] = "cpu"
    os.environ[LOCAL_DEVICES_ENV] = str(n)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@mode("mh_test", help="multi-process self-check: N torch.distributed "
                      "processes run one sharded forward; rank 0 "
                      "spawns the others and verifies digests agree")
class MhTest(HasMain):
    coordinator = Attr(str, default="",
                       help="host:port of the process group's rendezvous "
                            "(default: pick a free local port; rank 0 must "
                            "be the coordinator host)")
    num_processes = Attr(int, default=2)
    process_id = Attr(int, default=0,
                      help="this process's rank (0 spawns 1..N-1)")
    spawn = Attr(bool, default=True,
                 help="rank 0 spawns the other ranks via exec-self "
                      "(cs_test_master idiom); 0 = every rank is "
                      "launched externally")
    local_devices = Attr(int, default=0,
                         help="if >0: run on the CPU with this many slots "
                              "per process (the multi-node-without-a-"
                              "cluster test rig); 0 = the environment's "
                              "device and slots")
    model = Attr(str, default="mini")
    batch = Attr(int, default=0, help="0: 2 per global device")
    ysz = Attr(int, default=32)
    mp = Attr(int, default=1, help="model-parallel mesh width")
    train = Attr(bool, default=False,
                 help="run one sharded TRAINING step (softmax-CE + SGD, "
                      "grads summed across ranks) instead of a forward; "
                      "the digest covers the updated weights")

    def _apply_local_env(self) -> None:
        if self.local_devices:
            force_local_cpu_devices(self.local_devices)

    def _spawn_cmd(self, rank: int, coord: str) -> list:
        return [sys.executable, "-m", "boda_tpu_torch", "mh_test",
                f"--coordinator={coord}",
                f"--num-processes={self.num_processes}",
                f"--process-id={rank}", "--spawn=0",
                f"--local-devices={self.local_devices}",
                f"--model={self.model}", f"--batch={self.batch}",
                f"--ysz={self.ysz}", f"--mp={self.mp}",
                f"--train={int(self.train)}"]

    def _digest_line(self) -> str:
        """Join the process group, run the sharded forward (or training
        step), return the digest line (printed by every rank)."""
        import numpy as np
        import torch

        init_multihost(self.coordinator, self.num_processes,
                       self.process_id)
        from ..core.digest import nda_digest
        from ..core.timers import global_timer_log
        from ..engine.torch_fwd import build_forward
        from .dryrun import TRAIN_TUNE, _fused_for
        from .mesh import COLLECTIVE_TIMER, global_devices, make_mesh, \
            plan_shardings, sum_over_ranks
        devs = global_devices()
        if len(devs) % self.mp:
            raise RtErr(f"mh_test: {len(devs)} devices not divisible "
                        f"by mp={self.mp}")
        mesh = make_mesh(mp=self.mp, devices=devs)
        dev = mesh.device(mesh.local_positions()[0])
        batch = self.batch or 2 * len(devs)
        pipe, plan, _fwd, weights = _fused_for(
            self.model, tune=TRAIN_TUNE if self.train else "", device=dev,
            batch=batch, ysz=self.ysz, xsz=self.ysz)
        _in_sh, w_sh = plan_shardings(plan, mesh)
        d = pipe.get_data_img_dims()
        x = np.random.RandomState(0).randn(*d.shape).astype(np.float32) * 0.1
        data_node = pipe.data_img_node_names[0]
        top = plan.output_nodes[-1]
        mfwd = build_forward(plan, mesh=mesh)
        xt = torch.from_numpy(x).to(dev)
        if self.train:
            from ..apps.train import build_train_step
            n_cls = plan.node_dims[top].shape[1]
            labels = torch.from_numpy(np.random.RandomState(1).randint(
                0, n_cls, size=(batch,)).astype(np.int32)).to(dev)
            # the batch-sharded grads are summed across ranks
            step = build_train_step(
                mfwd, data_node, top, lr=0.01,
                grad_reduce=lambda g: sum_over_ranks(mesh, g))
            wk = sorted(w_sh)[0]

            def run():
                loss, new_w, _vel = step(weights, {}, xt, labels)
                return (new_w[wk].detach().cpu().numpy(),
                        f"loss={float(loss):.6f} {wk}")
        else:
            def run():
                with torch.no_grad():
                    return mfwd({data_node: xt}, weights)[top].cpu().numpy(), \
                        top
        # the first run builds the kernels and warms the libraries; the
        # second, from the same weights and data, is timed and digested
        run()
        c0 = global_timer_log.tags.get(COLLECTIVE_TIMER, (0, 0.0))[1]
        t0 = time.perf_counter()
        out, what = run()
        step_ms = (time.perf_counter() - t0) * 1e3
        coll_ms = (global_timer_log.tags.get(COLLECTIVE_TIMER, (0, 0.0))[1]
                   - c0) * 1e3
        self.timing_line = (
            f"mh_test rank {self.process_id}/{self.num_processes} "
            f"{'train step' if self.train else 'forward'} "
            f"ms={step_ms:.3f} collectives_ms={coll_ms:.3f} on {dev}")
        if not np.isfinite(out).all():
            raise RtErr("mh_test: non-finite output")
        return (f"mh_test rank {self.process_id}/{self.num_processes} "
                f"global_devices={len(devs)} {what} digest "
                f"{nda_digest(out)}")

    def main(self):
        if self.num_processes < 1:
            raise RtErr("mh_test: num_processes must be >= 1")
        if not (0 <= self.process_id < self.num_processes):
            raise RtErr(f"mh_test: process_id {self.process_id} out of "
                        f"range for num_processes={self.num_processes}")
        self._apply_local_env()
        if self.process_id != 0 or not self.spawn:
            try:
                line = self._digest_line()
                print(self.timing_line, flush=True)
                print(line, flush=True)
            finally:
                shutdown_multihost()
            return
        if self.num_processes > 1 and not self.local_devices:
            # the JAX package's rule, kept: spawned ranks share this
            # machine's devices; ranks on real devices are launched one per
            # host externally
            raise RtErr("mh_test: spawn=1 with num_processes>1 needs "
                        "--local-devices=N (slots on the CPU); for real "
                        "multi-host, launch one rank per host externally "
                        "with --spawn=0")
        import tempfile
        coord = self.coordinator or f"localhost:{free_port()}"
        self.coordinator = coord
        # children write to temp FILES, not pipes: a rank blocking on a
        # full pipe before its shutdown would deadlock rank 0
        logs = [tempfile.NamedTemporaryFile(
                    mode="w+", suffix=f".mh{r}.log", delete=False)
                for r in range(1, self.num_processes)]
        kids = [subprocess.Popen(self._spawn_cmd(r, coord),
                                 stdout=lg, stderr=subprocess.STDOUT,
                                 text=True, env=dict(os.environ))
                for r, lg in zip(range(1, self.num_processes), logs)]
        try:
            try:
                mine = self._digest_line()
            finally:
                # rank 0 leaves the group before it waits on the children
                shutdown_multihost()
            print(self.timing_line, flush=True)
            print(mine, flush=True)
            my_digest = mine.split("digest ", 1)[1]
            for r, (k, lg) in enumerate(zip(kids, logs), start=1):
                try:
                    rc = k.wait(timeout=RANK_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    raise RtErr(f"mh_test: rank {r} still running after "
                                f"{RANK_TIMEOUT_S} s")
                lg.seek(0)
                out = lg.read()
                if rc != 0:
                    raise RtErr(f"mh_test: rank {r} failed "
                                f"(exit {rc}): {out.strip()[-300:]}")
                lines = [ln for ln in out.splitlines() if "digest " in ln]
                if not lines:
                    raise RtErr(f"mh_test: rank {r} printed no digest")
                theirs = lines[-1].split("digest ", 1)[1]
                if theirs != my_digest:
                    raise RtErr(f"mh_test: rank {r} digest differs:\n"
                                f"  rank0: {my_digest}\n  rank{r}: {theirs}")
        finally:
            for k in kids:
                if k.poll() is None:
                    k.kill()
                    k.wait()
            for lg in logs:
                lg.close()
                os.unlink(lg.name)
        print(f"mh_test PASSED ranks={self.num_processes} "
              f"model={self.model}", flush=True)
