"""Remote-execution backend: the `ipc` rtc backend equivalent.

The port's copy of boda_tpu/backend/ipc.py. Capability parity with
rtc_ipc.cc: a client proxy (`be=ipc`) implementing the FULL Backend
contract by serializing each verb over a byte stream (rtc_ipc.cc:82) to a
worker process running mode `ipc_compute_worker` (:333), whose main loop
dispatches init/compile/run/copy/get_dur/... commands (:352-457) against a
real inner backend and propagates errors back over the wire as (ret,
err_str) (:368-380). Worker spawn: fork/exec `python -m boda_tpu_torch`
over a socketpair, arbitrary spawn_str (the reference drove Android phones
via adb; here e.g. ssh to a machine with a card), or connect to a TCP
worker (test modes cs_test_master/worker, rtc_ipc.cc:290-330).

Where the reference shipped CUDA source text in `compile`, this protocol
ships *reduced op signatures*: both sides share the kernel-template
library, so the signature IS the program; the worker builds each template
for its inner backend (be=torch: the hand-written CUDA kernels on its
device, default the card; be=interp: the numpy ref_impl). The worker's
default inner backend is `torch`. One command the JAX protocol lacks,
`launches`, returns (and optionally zeroes) the worker's kernel launch
counters, so a master can see which hand kernels its calls ran.

Wire format: length-prefixed frames; payload = u32 header_len + lexp-text
header + raw binary tail (NDA bwrite blobs).
"""

from __future__ import annotations

import shlex
import struct
import subprocess
import sys
from typing import Optional

from ..core.config import Attr, register
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.lexp import Lexp, lexp_escape, parse_lexp
from ..parallel.transport import Stream, accept_stream, listen_socket, \
    make_stream
from .iface import Backend, CompiledFunc, RtcFuncCall

_HLEN = struct.Struct("<I")


def _pack(header: Lexp, tail: bytes = b"") -> bytes:
    h = str(header).encode()
    return _HLEN.pack(len(h)) + h + tail


def _unpack(payload: bytes) -> tuple[Lexp, bytes]:
    (hl,) = _HLEN.unpack_from(payload, 0)
    header = parse_lexp(payload[4:4 + hl].decode())
    return header, payload[4 + hl:]


def _hdr(cmd: str, **kw) -> Lexp:
    l = Lexp.empty_list()
    l.add_key_val("cmd", cmd)
    for k, v in kw.items():
        if isinstance(v, Lexp):
            l.add_key_lexp(k, v)
        else:
            l.add_key_val(k, str(v))
    return l


@register(Backend, "ipc", help="remote worker backend (subprocess/TCP proxy)")
class IpcBackend(Backend):
    kind = "remote"
    boda_parent_addr = Attr(str, default="",
                            help="connect to worker at this address "
                                 "(tcp:host:port); default: spawn subprocess")
    spawn_str = Attr(str, default="",
                     help="worker launch command (shell-split); %%(addr), "
                          "%%(host), %%(port) expand to the master's TCP "
                          "listener (e.g. 'ssh -R %%(port):127.0.0.1:%%(port)"
                          " gpu-host python -m boda_tpu_torch "
                          "ipc_compute_worker "
                          "--boda-parent-addr=tcp:127.0.0.1:%%(port) "
                          "--rtc=torch' drives a card on another host over "
                          "a reverse-forwarded port, the reference's "
                          "adb-phone-worker pattern, rtc_ipc.cc:290)")
    worker_be = Attr(str, default="torch",
                     help="inner backend spec for the worker")
    print_dont_fork = Attr(bool, default=False,
                           help="print the worker command and wait instead "
                                "of spawning (manual-launch workflow)")

    def init(self) -> None:
        self._proc: Optional[subprocess.Popen] = None
        if self.boda_parent_addr:
            self.stream = make_stream(self.boda_parent_addr)
        elif self.spawn_str:
            # bind an ephemeral listener FIRST so the spawned worker's
            # connect can't race the accept; then expand the launch command
            from ..core.lexp import NameValScope, str_format_from_nvm
            srv = listen_socket(0)
            port = srv.getsockname()[1]
            nvm = NameValScope()
            nvm.insert_leafs_from({"addr": f"tcp:127.0.0.1:{port}",
                                   "host": "127.0.0.1", "port": port})
            cmd = shlex.split(str_format_from_nvm(self.spawn_str, nvm))
            if self.print_dont_fork:
                print("launch worker manually: " + shlex.join(cmd))
            else:
                self._proc = subprocess.Popen(cmd)
            srv.settimeout(300.0)  # remote env setup can be slow (ssh+init)
            self.stream = accept_stream(srv)
        else:
            import socket
            par, chi = socket.socketpair()
            chi_fd = chi.fileno()
            cmd = [sys.executable, "-m", "boda_tpu_torch", "ipc_compute_worker",
                   f"--boda-parent-addr=fds:{chi_fd}:{chi_fd}",
                   f"--rtc={self.worker_be}"]
            if self.print_dont_fork:
                print("launch worker manually: " + shlex.join(cmd))
            self._proc = subprocess.Popen(cmd, pass_fds=(chi_fd,))
            chi.close()
            self.stream = Stream(sock=par)
        hdr, _ = self._rpc(_hdr("init"))
        self._plat = hdr.get_kid("plat").leaf_val
        self._remote_funcs: set[str] = set()
        self._var_dims: dict[str, Dims] = {}
        self._n_calls = 0
        self._initialized = True

    def _rpc(self, header: Lexp, tail: bytes = b"") -> tuple[Lexp, bytes]:
        self.stream.write_frame(_pack(header, tail))
        rh, rt = _unpack(self.stream.read_frame())
        rh.deep_inc_use_cnt()
        if rh.get_kid("ret").leaf_val != "ok":
            raise RtErr(f"ipc worker error: {rh.get_kid('err').leaf_val}")
        return rh, rt

    def get_plat_tag(self) -> str:
        self.ensure_init()
        return f"ipc:{self._plat}"

    # ---- vars ----
    def create_var_with_dims(self, name: str, dims: Dims) -> None:
        self.ensure_init()
        self._rpc(_hdr("create_var", name=name, dims=dims.to_lexp()))
        self._var_dims[name] = dims

    def create_var_with_dims_as_reshaped_view_of_var(self, name, dims, src):
        self._rpc(_hdr("create_view", name=name, dims=dims.to_lexp(), src=src))
        self._var_dims[name] = dims

    def get_var_dims(self, name: str) -> Dims:
        d = self._var_dims.get(name)
        if d is None:
            raise RtErr(f"no var '{name}'")
        return d

    def var_exists(self, name: str) -> bool:
        return name in self._var_dims

    def release_var(self, name: str) -> None:
        self._rpc(_hdr("release_var", name=name))
        self._var_dims.pop(name, None)

    def release_all_vars(self) -> None:
        self._rpc(_hdr("release_all"))
        self._var_dims.clear()

    def var_names(self):
        return list(self._var_dims)

    # ---- copies ----
    def copy_nda_to_var(self, name: str, nda: NDA) -> None:
        self._rpc(_hdr("copy_to_var", name=name), nda.bwrite())

    def copy_var_to_nda(self, name: str) -> NDA:
        _h, tail = self._rpc(_hdr("copy_from_var", name=name))
        nda, _ = NDA.bread(tail)
        return nda

    # ---- compile / run / timing ----
    def compile(self, funcs: list[CompiledFunc]) -> None:
        self.ensure_init()
        sigs = Lexp.empty_list()
        for f in funcs:
            if getattr(f, "sig_meta", None) is None:
                raise RtErr("ipc backend: compile needs signature metadata "
                            "(was the Codegen built against a local backend?)")
            tname, rfs = f.sig_meta
            e = Lexp.empty_list()
            e.add_key_val("inst", f.name)
            e.add_key_val("tname", tname)
            e.add_key_lexp("rfs", rfs.to_lexp())
            sigs.add_key_lexp("_", e)
        self._rpc(_hdr("compile", sigs=sigs))
        for f in funcs:
            self._remote_funcs.add(f.name)
            self._funcs[f.name] = f  # local record for func_exists

    def func_exists(self, name: str) -> bool:
        return name in self._remote_funcs

    def run(self, call: RtcFuncCall) -> int:
        args = Lexp.empty_list()
        tail = b""
        for an, av in call.args.items():
            if isinstance(av, NDA):
                args.add_key_val(an, "__byval__")
                tail += av.bwrite()
            else:
                args.add_key_val(an, av)
        hdr, _ = self._rpc(_hdr("run", func=call.func_name, args=args), tail)
        call.call_id = int(hdr.get_kid("call_id").leaf_val)
        return call.call_id

    def finish_and_sync(self) -> None:
        self._rpc(_hdr("finish"))

    def get_dur(self, b: int, e: int) -> float:
        hdr, _ = self._rpc(_hdr("get_dur", b=b, e=e))
        return float(hdr.get_kid("secs").leaf_val)

    def launches(self, reset: bool = False) -> dict[str, int]:
        """The worker's kernel launch counters (ops/cuda/util.
        launch_counts), read before they are zeroed where reset."""
        hdr, _ = self._rpc(_hdr("launches", reset=int(reset)))
        return {n: int(v.leaf_val)
                for n, v in hdr.get_kid("counts").iter_kids()}

    def quit_worker(self) -> None:
        try:
            self.stream.write_frame(_pack(_hdr("quit")))
            self.stream.read_frame()  # wait for 'bye' so the worker's reply
            self.stream.close()       # write never hits a closed stream
        except Exception:
            pass
        if self._proc is not None:
            self._proc.wait(timeout=10)


# ---- worker side ----

from ..core.has_main import HasMain, mode  # noqa: E402


@mode("ipc_compute_worker", help="serve Backend verbs over a stream")
class IpcComputeWorker(HasMain):
    boda_parent_addr = Attr(str, req=True, help="stream address to serve on")
    rtc = Attr(Backend, default="torch", help="inner backend")

    def main(self):
        from ..ops.cuda.util import launch_counts
        from ..ops.registry import bind_template, get_template
        st = make_stream(self.boda_parent_addr, is_server=True)
        be = self.rtc
        while True:
            try:
                frame = st.read_frame()
            except RtErr:
                break  # EOF: master went away
            hdr, tail = _unpack(frame)
            hdr.deep_inc_use_cnt()
            cmd = hdr.get_kid("cmd").leaf_val

            def k(n):
                return hdr.get_kid(n)

            try:
                if cmd == "quit":
                    st.write_frame(_pack(_hdr("bye", ret="ok")))
                    break
                elif cmd == "init":
                    be.ensure_init()
                    st.write_frame(_pack(_hdr("r", ret="ok", plat=be.get_plat_tag())))
                elif cmd == "create_var":
                    be.create_var_with_dims(k("name").leaf_val,
                                            Dims.from_lexp(k("dims")))
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "create_view":
                    be.create_var_with_dims_as_reshaped_view_of_var(
                        k("name").leaf_val, Dims.from_lexp(k("dims")),
                        k("src").leaf_val)
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "release_var":
                    be.release_var(k("name").leaf_val)
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "release_all":
                    be.release_all_vars()
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "copy_to_var":
                    nda, _ = NDA.bread(tail)
                    be.copy_nda_to_var(k("name").leaf_val, nda)
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "copy_from_var":
                    nda = be.copy_var_to_nda(k("name").leaf_val)
                    st.write_frame(_pack(_hdr("r", ret="ok"), nda.bwrite()))
                elif cmd == "compile":
                    from ..ops.op_base import OpBase
                    cfs = []
                    for _n, e in k("sigs").iter_kids():
                        e.deep_inc_use_cnt()
                        tname = e.get_kid("tname").leaf_val
                        rfs = OpBase.from_lexp(e.get_kid("rfs"))
                        tmpl = get_template(tname)
                        cf = CompiledFunc(e.get_kid("inst").leaf_val,
                                          bind_template(tmpl, rfs, be),
                                          tmpl.in_args(), tmpl.out_args(),
                                          tmpl.io_args(), flops=tmpl.flops(rfs))
                        cf.present_args = {a.name for a in tmpl.args
                                           if a.name in rfs.nda_vals}
                        cfs.append(cf)
                    be.compile(cfs)
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "run":
                    args = {}
                    off = 0
                    for an, av in k("args").iter_kids():
                        if av.leaf_val == "__byval__":
                            nda, off = NDA.bread(tail, off)
                            args[an] = nda
                        else:
                            args[an] = av.leaf_val
                    cid = be.run(RtcFuncCall(k("func").leaf_val, args))
                    st.write_frame(_pack(_hdr("r", ret="ok", call_id=cid)))
                elif cmd == "finish":
                    be.finish_and_sync()
                    st.write_frame(_pack(_hdr("r", ret="ok")))
                elif cmd == "get_dur":
                    secs = be.get_dur(int(k("b").leaf_val), int(k("e").leaf_val))
                    st.write_frame(_pack(_hdr("r", ret="ok", secs=f"{secs:.9g}")))
                elif cmd == "launches":
                    counts = Lexp.empty_list()
                    for n, c in launch_counts(
                            reset=k("reset").leaf_val == "1").items():
                        counts.add_key_val(n, str(c))
                    st.write_frame(_pack(_hdr("r", ret="ok", counts=counts)))
                else:
                    raise RtErr(f"ipc worker: unknown command '{cmd}'")
            except Exception as e:  # error propagation over the wire
                st.write_frame(_pack(_hdr("r", ret="err",
                                          err=f"{type(e).__name__}: {e}")))
        st.close()


@mode("cs_test_master", help="IPC self-test: spawn a worker and run rtc_test over it")
class CsTestMaster(HasMain):
    worker_be = Attr(str, default="interp")
    n = Attr(int, default=512)

    def main(self):
        from ..core.has_main import create_and_run_has_main
        be_spec = f"(be=ipc,worker_be={lexp_escape(self.worker_be)})"
        create_and_run_has_main(
            f"(mode=rtc_test,n={self.n},rtc={be_spec})", global_vars={})
        print("cs_test_master PASSED")
