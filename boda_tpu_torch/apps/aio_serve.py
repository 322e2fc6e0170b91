"""Async host concurrency: dynamic-batching inference service.

Reference parity: the asio event-loop layer (`asio_util.H`,
`cap_app.cc`'s multiplexed fd/stream handling; SURVEY §2.5 "asio host
concurrency"): an asyncio TCP server multiplexes MANY concurrent clients
onto ONE engine, and coalesces their requests into batches (a bounded
batching window) before dispatch; per-client batch-1 calls would leave
the card's tensor cores idle (the reference's asio loop solved the same
"many slow producers, one fast consumer" problem for capture devices).

The port's copy of boda_tpu/apps/aio_serve.py (aio_cls_server,
serve_bench, aio_cls_selfcheck), whose engine defaults to engine=torch on
the card. The engine call runs in the event loop's executor thread and
ends in a host readback of the probabilities, so a batch's engine
seconds are the card's real time, not a launch time. Under wire_fmt=u8
the engine preprocesses the raw uint8 batch on the card
(TorchFwd.set_input_preproc with io/device_preproc.device_preproc_fn).

Wire protocol: the framed-stream format of parallel/transport.py
(4-byte LE length prefix per frame), so sync `Stream` peers interoperate:

  request = [opts lexp frame, dims lexp frame, raw bytes frame]
            opts: (op=classify[,top_k=K])  or  (op=quit) [no nda frames]
  reply   = [opts lexp frame, dims lexp frame, raw bytes frame]
            opts: (batch=B) — the realized engine batch (coalescing proof)
            nda:  float (obj=top_k, cls_prob=2) rows of [class, prob]
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.config import Attr
from ..core.dims import NDA, Dims
from ..core.error import RtErr
from ..core.has_main import mode
from ..core.lexp import Lexp, parse_lexp
from .run_cnet import RunCnetBase

_LEN = struct.Struct("<I")


async def _read_frame(reader) -> bytes:
    hdr = await reader.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    return await reader.readexactly(n)


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + payload


@mode("aio_cls_server", help="asyncio dynamic-batching classification server")
class AioClsServer(RunCnetBase):
    port = Attr(int, req=True, help="TCP port to listen on (127.0.0.1)")
    max_batch = Attr(int, default=8, help="engine batch = coalescing cap")
    batch_window_ms = Attr(float, default=20.0,
                           help="wait this long after the first queued "
                                "request for more to coalesce")
    top_k = Attr(int, default=3)
    num_requests = Attr(int, default=0,
                        help="serve this many classify requests then exit "
                             "(0 = until a (op=quit) request)")
    wire_fmt = Attr(str, default="f32",
                    help="request image wire format: f32 = preprocessed "
                         "(chan,y,x) float32 (host img_to_chw); u8 = raw "
                         "(y,x,chan) uint8 RGB — mean-subtract/BGR/"
                         "transpose run ON THE CARD in front of the "
                         "forward (4x smaller upload)")
    u8_bgr = Attr(bool, default=True,
                  help="u8 wire format: RGB→BGR swap on the card")
    u8_mean = Attr(str, default="104.0,117.0,123.0",
                   help="u8 wire format: per-channel mean to subtract on "
                        "the card (empty = none); matches img_to_chw's "
                        "host-side defaults so both formats agree")
    _started_cb = None   # test hook: called with the bound port

    def setup(self):
        self.batch = self.max_batch
        pipe = self.setup_cnet()
        # measurement provenance: surface the engine's tune-resolution
        # lines (op_tunes_pat / wisdom / act_scales) so a serving bench
        # records WHICH engine config it measured
        il = getattr(self.conv_fwd, "get_info_log", lambda: "")()
        if il:
            print(il, flush=True)
        d = pipe.get_data_img_dims()
        self._img_dims = (d["chan"], d["y"], d["x"])
        self._data_dims = d
        self._in_dims = d
        if self.wire_fmt == "u8":
            from ..io.device_preproc import device_preproc_fn
            mean = tuple(float(v) for v in self.u8_mean.split(",")) \
                if self.u8_mean else None
            self._img_dims = (d["y"], d["x"], 3)
            self._in_dims = Dims.make(tn="uint8_t", img=d["img"],
                                      y=d["y"], x=d["x"], chan=3)
            # the engine checks each wire batch against _in_dims, and the
            # preprocessed batch against the plan's data dims
            self.conv_fwd.set_input_preproc(
                pipe.data_img_node_names[0],
                device_preproc_fn(d["y"], d["x"], bgr=self.u8_bgr,
                                  mean=mean, dtype=d.dtype),
                self._in_dims)
        elif self.wire_fmt != "f32":
            raise RtErr(f"unknown wire_fmt '{self.wire_fmt}' "
                        "(expected f32 or u8)")
        self._served = 0
        self._batch_sizes: list[int] = []
        # latency decomposition: per-request queueing wait (enqueue -> its
        # batch's engine call starts) and per-batch engine time (the
        # blocking classify_batch call: upload, forward on the card,
        # readback) — lets serve_bench split ms/req into queueing vs
        # engine
        self._queue_wait_sum = 0.0
        self._engine_sec_sum = 0.0

    def stats_snapshot(self) -> tuple:
        """(served, batches, queue_wait_sum_s, engine_sec_sum_s) — phase
        deltas of this tuple decompose serving latency."""
        return (self._served, len(self._batch_sizes),
                self._queue_wait_sum, self._engine_sec_sum)

    def classify_batch(self, imgs: list[np.ndarray], top_k: int) -> list[np.ndarray]:
        """Pad to max_batch, one engine call, per-request top-k rows."""
        x = np.zeros(self._in_dims.shape, self._in_dims.dtype)
        for i, im in enumerate(imgs):
            x[i] = im
        out = self.run_one_blob_in_one_blob_out(NDA(self._in_dims, x))
        probs = np.asarray(out.v).reshape(self._data_dims["img"], -1)
        res = []
        for i in range(len(imgs)):
            idx = np.argsort(-probs[i])[:top_k]
            res.append(np.stack([idx.astype(np.float32),
                                 probs[i][idx].astype(np.float32)], axis=1))
        return res

    async def _serve(self):
        import asyncio
        queue: asyncio.Queue = asyncio.Queue()
        done = asyncio.Event()
        loop = asyncio.get_running_loop()

        async def batcher():
            while not done.is_set():
                get = asyncio.create_task(queue.get())
                dn = asyncio.create_task(done.wait())
                await asyncio.wait({get, dn}, return_when=asyncio.FIRST_COMPLETED)
                if not get.done():
                    get.cancel()
                    # cancel race: the get may have already
                    # dequeued a request onto its result between done firing
                    # and the cancel landing — losing it would leave that
                    # client's future unresolved until connection teardown
                    try:
                        item = await get
                    except asyncio.CancelledError:
                        item = None
                    if item is not None:
                        try:
                            t0 = loop.time()
                            self._queue_wait_sum += t0 - item[3]
                            res = await loop.run_in_executor(
                                None, self.classify_batch, [item[0]], item[1])
                            self._engine_sec_sum += loop.time() - t0
                            if not item[2].done():
                                item[2].set_result((1, res[0][:item[1]]))
                            self._batch_sizes.append(1)
                            self._served += 1
                        except Exception as e:
                            if not item[2].done():
                                item[2].set_exception(RtErr(f"engine error: {e}"))
                    return
                dn.cancel()
                batch = [get.result()]
                deadline = loop.time() + self.batch_window_ms / 1e3
                while len(batch) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(queue.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                imgs = [b[0] for b in batch]
                tk = max(b[1] for b in batch)
                # engine call is blocking: run off the event loop so new
                # requests keep queuing for the next batch
                t0 = loop.time()
                for b in batch:
                    self._queue_wait_sum += t0 - b[3]
                try:
                    res = await loop.run_in_executor(
                        None, self.classify_batch, imgs, tk)
                    self._engine_sec_sum += loop.time() - t0
                except Exception as e:  # propagate to waiting clients
                    import traceback
                    traceback.print_exc()
                    for (_, _k, fut, _t) in batch:
                        if not fut.done():
                            fut.set_exception(RtErr(f"engine error: {e}"))
                    done.set()
                    return
                self._batch_sizes.append(len(batch))
                for (_, k, fut, _t), r in zip(batch, res):
                    if not fut.done():
                        fut.set_result((len(batch), r[:k]))
                self._served += len(batch)
                if self.num_requests and self._served >= self.num_requests:
                    done.set()
                    return

        async def handle(reader, writer):
            try:
                while True:
                    opts = parse_lexp((await _read_frame(reader)).decode())
                    opts.deep_inc_use_cnt()
                    op = opts.get_kid("op").leaf_val if opts.get_kid("op") else ""
                    if op == "quit":
                        writer.write(_frame(b"(ok=1)"))
                        await writer.drain()
                        done.set()
                        return
                    if op != "classify":
                        writer.write(_frame(f"(err=unknown op '{op}')".encode()))
                        await writer.drain()
                        continue
                    tk = int(opts.get_kid("top_k").leaf_val) \
                        if opts.get_kid("top_k") else self.top_k
                    dims = Dims.from_lexp(parse_lexp(
                        (await _read_frame(reader)).decode()))
                    raw = await _read_frame(reader)
                    img = np.frombuffer(raw, dtype=dims.dtype).reshape(dims.shape)
                    if tuple(img.shape) != self._img_dims \
                            or img.dtype != self._in_dims.dtype:
                        writer.write(_frame(
                            f"(err=bad image dims {img.shape} "
                            f"dtype {img.dtype} for wire_fmt "
                            f"{self.wire_fmt})".encode()))
                        await writer.drain()
                        continue
                    fut = loop.create_future()
                    await queue.put((img, tk, fut, loop.time()))
                    bsz, rows = await fut
                    rd = Dims.make(tn="float", obj=rows.shape[0], cls_prob=2)
                    writer.write(_frame(f"(batch={bsz})".encode())
                                 + _frame(str(rd.to_lexp()).encode())
                                 + _frame(np.ascontiguousarray(rows).tobytes()))
                    await writer.drain()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                return
            finally:
                writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", self.port)
        port = server.sockets[0].getsockname()[1]
        print(f"aio_cls_server: listening on 127.0.0.1:{port} "
              f"max_batch={self.max_batch} window={self.batch_window_ms}ms",
              flush=True)
        if AioClsServer._started_cb:
            AioClsServer._started_cb(port)
        bt = asyncio.create_task(batcher())
        async with server:
            await done.wait()
        await bt
        print(f"aio_cls_server: served {self._served} request(s) in "
              f"{len(self._batch_sizes)} batch(es), "
              f"max_batch_seen={max(self._batch_sizes or [0])}", flush=True)

    def main(self):
        import asyncio
        self.setup()
        asyncio.run(self._serve())


@mode("serve_bench",
      help="slope-timed serving throughput: k clients through the "
           "dynamic-batching server")
class ServeBench(RunCnetBase):
    """Batched serving-throughput measurement (reference serving surface:
    the zmq detection service, zmq-util.cc:101-150, which published no
    numbers). One server + engine stays up; k persistent clients run two
    barrier-synced phases of n1 and n2 requests each, and the report is
    the SLOPE (T2-T1)/(k*(n2-n1)) of the clients' wall clock — cancelling
    the kernel builds, connection setup and any fixed per-request cost.

    After main: `srv` is the server (its engine, its counters), `imgs[i]`
    the image client i sent, `replies[i]` its last reply (batch, rows)
    and `record` the numbers of the printed record."""

    num_clients = Attr(int, default=8)
    n1 = Attr(int, default=4, help="short phase: requests per client")
    n2 = Attr(int, default=16, help="long phase: requests per client")
    top_k = Attr(int, default=1)
    max_batch = Attr(int, default=0, help="coalescing cap (0 = num_clients)")
    batch_window_ms = Attr(float, default=20.0)
    wire_fmt = Attr(str, default="f32",
                    help="image wire format (f32 = host-preprocessed CHW, "
                         "u8 = raw HWC with device-fused preprocessing)")
    engine = Attr(str, default="",
                  help="conv_fwd spec lexp forwarded to the server, e.g. "
                       "(engine=torch,op_tune=(...),op_tunes_pat="
                       "(...quant8 sites...),act_scales_fn=...) — the "
                       "int8 serving A/B; (engine=torch,device=cpu) off "
                       "the card")
    out_fn = Attr(str, default="", help="also append a one-line lexp record here")

    def main(self):
        import threading
        import time

        from ..io.img import img_to_chw, make_test_pattern_img
        from ..parallel.transport import make_stream

        srv_cfg = {
            "model": self.model or "mini",
            "batch": str(self.batch),
            "port": "0",
            "max_batch": str(self.max_batch or self.num_clients),
            "batch_window_ms": str(self.batch_window_ms),
            "num_requests": "0",  # quit-driven: engine survives both phases
            "wire_fmt": self.wire_fmt,
            "top_k": str(self.top_k)}
        if self.model_opts:
            srv_cfg["model_opts"] = self.model_opts
        if self.weights_fn:
            srv_cfg["weights_fn"] = self.weights_fn
        if self.engine:
            srv_cfg["conv_fwd"] = parse_lexp(self.engine)
        srv = self.srv = AioClsServer.init_from_lexp(Lexp.from_obj(srv_cfg))
        port_box = {}
        port_evt = threading.Event()
        AioClsServer._started_cb = staticmethod(
            lambda p: (port_box.update(port=p), port_evt.set()))
        k = self.num_clients
        phase_secs = {}
        errs = [None] * k
        start_bar = threading.Barrier(k)
        done_bars = {ph: threading.Barrier(k) for ph in ("warm", "p1", "p2")}
        lock = threading.Lock()

        snaps = {}
        self.imgs, self.replies = [None] * k, [None] * k

        def run_phase(i, st, img, tag, n, snap=False):
            start_bar.wait()
            t0 = time.perf_counter()
            for _ in range(n):
                self.replies[i] = classify_over_stream(st, img, self.top_k)
            done_bars[tag].wait()  # phase ends when the SLOWEST client ends
            dt = time.perf_counter() - t0
            with lock:
                phase_secs[tag] = max(phase_secs.get(tag, 0.0), dt)
            if snap:
                # every client passed the barrier with all its requests
                # resolved, so the server's counters are phase-complete
                snaps[tag] = srv.stats_snapshot()

        def client(i):
            try:
                d = srv._img_dims
                if self.wire_fmt == "u8":
                    # raw HWC u8 on the wire: 4x less TCP + device upload
                    img = np.ascontiguousarray(make_test_pattern_img(
                        d[0], d[1], mode=i + 1), np.uint8)
                else:
                    img = img_to_chw(make_test_pattern_img(
                        d[1], d[2], mode=i + 1)).astype(np.float32)
                self.imgs[i] = img
                st = make_stream(f"tcp:127.0.0.1:{port_box['port']}", impl="py")
                run_phase(i, st, img, "warm", 1)
                run_phase(i, st, img, "p1", self.n1, snap=(i == 0))
                run_phase(i, st, img, "p2", self.n2, snap=(i == 0))
                if i == 0:
                    st.write_frame(b"(op=quit)")
                    st.read_frame()
                st.close()
            except Exception as e:
                errs[i] = e
                # a failed client must not strand the others at a barrier
                start_bar.abort()
                for b in done_bars.values():
                    b.abort()

        try:
            th = threading.Thread(target=srv.main, daemon=True)
            th.start()
            assert port_evt.wait(120), "server did not start"
            cs = [threading.Thread(target=client, args=(i,), daemon=True)
                  for i in range(k)]
            for c in cs:
                c.start()
            for c in cs:
                c.join(600)
            th.join(120)
        finally:
            AioClsServer._started_cb = None
        for i, e in enumerate(errs):
            if e is not None:
                raise RtErr(f"serve_bench client {i} failed: {e}")
        dreq = k * (self.n2 - self.n1)
        dt = phase_secs["p2"] - phase_secs["p1"]
        # dt <= 0 happens under host timing noise (p1 hit by a scheduler
        # stall): the slope is unresolved — report nan, not a fake number
        rps = dreq / dt if dt > 0 else float("nan")
        bs = srv._batch_sizes
        mean_b = sum(bs) / len(bs) if bs else 0.0
        # latency decomposition: p2-p1 deltas of the server-side counters
        # split ms/req into queueing (enqueue -> engine-call start;
        # batching window + engine-busy head-of-line blocking) vs engine
        # (the blocking classify call: upload, forward on the card,
        # readback). The deltas cancel the warm phase's kernel builds
        # like the throughput number does.
        d_req = snaps["p2"][0] - snaps["p1"][0]
        d_bat = snaps["p2"][1] - snaps["p1"][1]
        d_qw = snaps["p2"][2] - snaps["p1"][2]
        d_eng = snaps["p2"][3] - snaps["p1"][3]
        q_ms = d_qw / d_req * 1e3 if d_req else 0.0
        eng_ms_b = d_eng / d_bat * 1e3 if d_bat else 0.0
        eng_ms_r = d_eng / d_req * 1e3 if d_req else 0.0
        p2_b = d_req / d_bat if d_bat else 0.0
        rec = (f"(mode=serve_bench,model={self.model or 'mini'},"
               f"clients={k},req_per_sec={rps:.1f},"
               f"secs_per_req={dt / dreq if dreq else 0:.6f},"
               f"mean_batch={mean_b:.2f},batches={len(bs)},"
               f"queue_ms_per_req={q_ms:.3f},engine_ms_per_batch={eng_ms_b:.3f},"
               f"engine_ms_per_req={eng_ms_r:.3f},p2_batch={p2_b:.2f})")
        self.record = dict(req_per_sec=rps,
                           secs_per_req=dt / dreq if dreq else 0.0,
                           mean_batch=mean_b, batches=len(bs),
                           queue_ms_per_req=q_ms,
                           engine_ms_per_batch=eng_ms_b,
                           engine_ms_per_req=eng_ms_r, p2_batch=p2_b)
        print(f"serve_bench: {k} clients, slope over {dreq} reqs: "
              f"{rps:.1f} req/s ({dt / dreq * 1e3 if dreq else 0:.2f} ms/req), "
              f"mean realized batch {mean_b:.2f}", flush=True)
        print(f"serve_bench decomposition (p2-p1): queue {q_ms:.2f} ms/req, "
              f"engine {eng_ms_b:.2f} ms/batch ({eng_ms_r:.2f} ms/req at "
              f"realized batch {p2_b:.2f})", flush=True)
        if self.out_fn:
            with open(self.out_path(self.out_fn), "a") as f:
                f.write(rec + "\n")


def classify_over_stream(stream, img: np.ndarray, top_k: int = 3):
    """Sync client helper over a transport Stream: returns (batch, rows).
    CHW float images name dims (chan,y,x); HWC uint8 (the u8 wire format)
    name them (y,x,chan)."""
    from ..core.dims import dtype_to_tn
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        d = Dims.make(tn=dtype_to_tn(img.dtype), y=img.shape[0],
                      x=img.shape[1], chan=img.shape[2])
    else:
        d = Dims.make(tn=dtype_to_tn(img.dtype), chan=img.shape[0],
                      y=img.shape[1], x=img.shape[2])
    stream.write_frame(f"(op=classify,top_k={top_k})".encode())
    stream.write_frame(str(d.to_lexp()).encode())
    stream.write_frame(np.ascontiguousarray(img).tobytes())
    opts = parse_lexp(stream.read_frame().decode())
    opts.deep_inc_use_cnt()
    if opts.get_kid("err") is not None:
        raise RtErr(f"aio server error: {opts.get_kid('err').leaf_val}")
    bsz = int(opts.get_kid("batch").leaf_val)
    rd = Dims.from_lexp(parse_lexp(stream.read_frame().decode()))
    rows = np.frombuffer(stream.read_frame(), dtype=rd.dtype).reshape(rd.shape)
    return bsz, rows


@mode("aio_cls_selfcheck",
      help="aio server + N concurrent clients in one process (smoke/golden)")
class AioClsSelfcheck(RunCnetBase):
    """The server runs this mode's own conv_fwd engine (engine=torch on the
    card by default; (engine=torch,device=cpu) off it)."""

    num_clients = Attr(int, default=3)
    top_k = Attr(int, default=2)
    # generous window: the golden asserts full batch=3 coalescing, which
    # needs all barrier-synced clients to land inside it even under CI load
    batch_window_ms = Attr(float, default=3000.0)

    def main(self):
        import threading

        from ..io.img import img_to_chw, make_test_pattern_img
        from ..parallel.transport import make_stream

        srv = AioClsServer.init_from_lexp(Lexp.from_obj({
            "model": self.model or "mini",
            "port": "0", "max_batch": str(self.num_clients),
            "batch_window_ms": str(self.batch_window_ms),
            "num_requests": str(self.num_clients),
            "top_k": str(self.top_k)}))
        srv.conv_fwd = self.conv_fwd
        port_box = {}
        port_evt = threading.Event()

        def started(port):
            port_box["port"] = port
            port_evt.set()

        AioClsServer._started_cb = staticmethod(started)
        try:
            th = threading.Thread(target=srv.main, daemon=True)
            th.start()
            assert port_evt.wait(60), "server did not start"
            port = port_box["port"]

            d = srv._img_dims
            results = [None] * self.num_clients
            barrier = threading.Barrier(self.num_clients)

            errs = [None] * self.num_clients

            def client(i):
                try:
                    img = img_to_chw(make_test_pattern_img(
                        d[1], d[2], mode=i + 1)).astype(np.float32)
                    st = make_stream(f"tcp:127.0.0.1:{port}", impl="py")
                    barrier.wait()
                    results[i] = classify_over_stream(st, img, self.top_k)
                    st.close()
                except Exception as e:
                    errs[i] = e

            cs = [threading.Thread(target=client, args=(i,))
                  for i in range(self.num_clients)]
            for c in cs:
                c.start()
            for c in cs:
                c.join(120)
            th.join(120)
        finally:
            AioClsServer._started_cb = None
        for i, r in enumerate(results):
            if errs[i] is not None:
                raise RtErr(f"client {i} failed: {errs[i]}")
            assert r is not None, f"client {i} got no reply"
            bsz, rows = r
            top = " ".join(f"{int(c)}:{p:.4f}" for c, p in rows)
            print(f"client {i}: batch={bsz} top-{self.top_k}: {top}")
        self._max_batch_seen = max(r[0] for r in results)
        print(f"selfcheck ok: {self.num_clients} clients, "
              f"max_batch_seen={self._max_batch_seen}")
