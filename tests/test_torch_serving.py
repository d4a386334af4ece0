"""ffrnet_torch.serving (EmbeddingService, EmbeddingHTTPServer) on the CPU.

The collector's logic runs on a stub model that records its dispatches,
so those cases cost no encoder pass. Then the port's service and HTTP
front with the port model holding the JAX model's weights, against
ffrnet_tpu's service and front on the same request bytes. Every JAX
dispatch is one bucket of 8, so the JAX side compiles one program.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from ffrnet_torch.api import FFRNet as TorchFFRNet
from ffrnet_torch.checkpoint.convert import backbone_state_dict, recnet_state_dict
from ffrnet_torch.eval.search import Gallery
from ffrnet_torch.models.irse import build_backbone
from ffrnet_torch.models.recnet import RecNetConfig, build_recnet
from ffrnet_torch.serving import EmbeddingHTTPServer, EmbeddingService
from ffrnet_tpu.api import FFRNet as JaxFFRNet
from ffrnet_tpu.data.datasets import _to_unit
from ffrnet_tpu.serving import EmbeddingHTTPServer as JaxHTTPServer
from ffrnet_tpu.serving import EmbeddingService as JaxService

torch.set_num_threads(1)

EMB_TOL = dict(atol=5e-5, rtol=0)   # fp32 embeddings, the two packages
VERIFY_TOL = dict(atol=1e-5, rtol=0)
IDENTIFY_TOL = dict(atol=2e-6, rtol=0)  # scores rounded to 6 places
WAIT = 60


def _faces(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 112, 112, 3), dtype=np.uint8)


# ------------------------------------------------------------ the collector


class Stub:
    """A model that records each dispatch (its input, its thread) and
    returns rows that identify each face: raw = the face's first 512
    values, rect = 2 * raw. `gate` holds a dispatch until set; `fail`
    makes the next dispatches raise."""

    device = torch.device("cpu")
    dtype = torch.float32

    def __init__(self):
        self.calls, self.threads = [], []
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.fail = None

    def embed(self, x):
        self.calls.append(x.clone())
        self.threads.append(threading.current_thread().name)
        self.entered.set()
        assert self.gate.wait(WAIT)
        if self.fail is not None:
            raise self.fail
        raw = x.reshape(x.shape[0], -1)[:, :512].clone()
        return raw, 2 * raw

    def hold(self):
        """Block the next dispatch until release()."""
        self.gate.clear()
        self.entered.clear()

    def release(self):
        self.gate.set()


def _first_row(face):
    return torch.from_numpy(np.ascontiguousarray(face).reshape(-1)[:512].astype(np.float32))


def test_coalesces_pads_and_resolves_each_request():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.05)
    x = _faces(5, 1)
    stub.hold()
    first = svc.submit(x[0])
    assert stub.entered.wait(WAIT)           # the collector is inside dispatch 1
    futs = [svc.submit(x[i]) for i in range(1, 5)]
    stub.release()
    outs = [f.result(WAIT) for f in [first] + futs]
    svc.close()
    assert [c.shape[0] for c in stub.calls] == [1, 4]   # 4 singles -> one bucket of 4
    for i, (raw, rect) in enumerate(outs):
        assert raw.shape == (1, 512)
        assert torch.equal(raw[0], _first_row(x[i]))
        assert torch.equal(rect, 2 * raw)
    s = svc.stats
    assert (s.requests, s.faces, s.batches, s.padded_faces, s.errors) == (5, 5, 2, 0, 0)
    assert list(s.batch_sizes) == [1, 4] and s.mean_batch == 2.5


def test_padding_rows_are_zero_faces_and_overflow_waits():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.05)
    x = _faces(11, 2)
    stub.hold()
    first = svc.submit(x[0])
    assert stub.entered.wait(WAIT)
    a, b = svc.submit(x[1:6]), svc.submit(x[6:11])  # 5 + 5 > 8: b waits
    stub.release()
    ra, rb = a.result(WAIT), b.result(WAIT)
    first.result(WAIT)
    svc.close()
    assert [c.shape[0] for c in stub.calls] == [1, 8, 8]
    assert torch.equal(stub.calls[1][:5], torch.from_numpy(x[1:6]))
    assert not stub.calls[1][5:].any()                      # zero faces
    assert torch.equal(ra[0], torch.stack([_first_row(f) for f in x[1:6]]))
    assert torch.equal(rb[0], torch.stack([_first_row(f) for f in x[6:11]]))
    assert svc.stats.padded_faces == 6 and list(svc.stats.batch_sizes) == [1, 5, 5]


def test_mixed_uint8_and_float_batch_is_bit_equal_to_host_normalization():
    """A uint8 group is normalized on the device; its rows equal the JAX
    package's host normalization (ffrnet_tpu.data.datasets._to_unit) to
    the bit, in a batch that also holds float groups."""
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.05)
    u8, fl = _u8(3, 3), _faces(2, 4)
    stub.hold()
    svc.submit(fl[:1])
    assert stub.entered.wait(WAIT)
    futs = [svc.submit(fl[1:]), svc.submit(u8), svc.submit(_to_unit(u8[:1]))]
    stub.release()
    (r_f, _), (r_u, _), (r_h, _) = [f.result(WAIT) for f in futs]
    svc.close()
    x = stub.calls[1]
    assert x.dtype == torch.float32 and x.shape[0] == 8
    assert torch.equal(x[:3], torch.from_numpy(_to_unit(u8)))      # uint8 groups first
    assert torch.equal(x[3:4], torch.from_numpy(fl[1:]))
    assert torch.equal(r_u, torch.stack([_first_row(f) for f in _to_unit(u8)]))
    assert torch.equal(r_h, r_u[:1]) and torch.equal(r_f[0], _first_row(fl[1]))


def test_submit_copies_its_input():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=4, max_delay_s=0.0)
    buf = _faces(2, 5)
    want = buf.copy()
    stub.hold()
    svc.submit(buf[:1])
    assert stub.entered.wait(WAIT)
    fut = svc.submit(buf)
    buf[:] = 0.0                        # the caller reuses its buffer at once
    stub.release()
    raw, _ = fut.result(WAIT)
    svc.close()
    assert torch.equal(stub.calls[1][:2], torch.from_numpy(want))
    assert torch.equal(raw, torch.stack([_first_row(f) for f in want]))


def test_cancelled_futures_are_skipped():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.05)
    x = _faces(3, 6)
    stub.hold()
    svc.submit(x[0])
    assert stub.entered.wait(WAIT)
    cancelled, kept = svc.submit(x[1]), svc.submit(x[2])
    assert cancelled.cancel()
    stub.release()
    raw, _ = kept.result(WAIT)
    svc.close()
    assert cancelled.cancelled()
    assert [c.shape[0] for c in stub.calls] == [1, 1]
    assert torch.equal(stub.calls[1][0], torch.from_numpy(x[2]))
    assert torch.equal(raw[0], _first_row(x[2]))
    assert svc.stats.faces == 2 and svc.stats.requests == 3


def test_errors_reach_every_future_and_the_collector_survives():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.05)
    x = _faces(4, 7)
    stub.hold()
    svc.submit(x[0]).add_done_callback(lambda f: None)
    assert stub.entered.wait(WAIT)
    stub.fail = RuntimeError("card fault")
    futs = [svc.submit(x[i]) for i in (1, 2, 3)]
    stub.release()
    for f in futs:
        with pytest.raises(RuntimeError, match="card fault"):
            f.result(WAIT)
    stub.fail = None
    raw, _ = svc.submit(x[1]).result(WAIT)  # the collector is still alive
    svc.close()
    assert torch.equal(raw[0], _first_row(x[1]))
    # the held first dispatch raised too: 1 + 3 futures
    assert svc.stats.errors == 4 and svc.stats.batches == 1


def test_empty_group_closed_service_and_bad_shapes():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=4, max_delay_s=0.0)
    raw, rect = svc.submit(np.zeros((0, 112, 112, 3), np.float32)).result(5)
    assert raw.shape == (0, 512) and rect.shape == (0, 512)
    with pytest.raises(ValueError):
        svc.submit(np.zeros((50, 50, 3), np.float32))
    with pytest.raises(ValueError, match="exceeds max_batch"):
        svc.submit(np.zeros((5, 112, 112, 3), np.float32))
    svc.close()
    assert stub.calls == [] and svc.stats.requests == 0
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((112, 112, 3), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        svc.warmup()
    with pytest.raises(ValueError):
        EmbeddingService(stub, max_batch=8, buckets=(1, 4))


def test_close_drains_the_queue():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=2, max_delay_s=0.0)
    x = _faces(6, 8)
    stub.hold()
    futs = [svc.submit(x[i]) for i in range(6)]
    threading.Timer(0.2, stub.release).start()
    svc.close(timeout=WAIT)             # resolves everything already accepted
    assert not svc._worker.is_alive()
    for i, f in enumerate(futs):
        raw, _ = f.result(0)
        assert torch.equal(raw[0], _first_row(x[i]))
    assert sum(c.shape[0] for c in stub.calls) == 6 + svc.stats.padded_faces


def test_warmup_runs_every_bucket_on_the_collector_and_raises():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=6, max_delay_s=0.0)
    svc.warmup()
    svc.submit(_faces(3, 9)).result(WAIT)
    assert [c.shape[0] for c in stub.calls] == [1, 2, 4, 6, 4]
    assert not any(c.any() for c in stub.calls[:4])
    assert set(stub.threads) == {"ffrnet-embed-service"}   # one launching thread
    assert svc.stats.batches == 1 and svc.stats.padded_faces == 1  # warmup uncounted
    stub.fail = RuntimeError("kernel build failed")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        svc.warmup()
    svc.close()


def test_many_clients_stress():
    """16 clients, 400 groups, a short switch interval: every future gets
    its own rows and the counters add up."""
    import sys

    stub = Stub()
    svc = EmbeddingService(stub, max_batch=16, max_delay_s=0.001)
    x = _faces(8, 10)
    errors, old = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(c):
        rng = np.random.default_rng(c)
        try:
            for _ in range(25):
                i = int(rng.integers(0, 8))
                k = int(rng.integers(1, 9 - i))
                raw, _ = svc.submit(x[i:i + k]).result(WAIT)
                if not torch.equal(raw, torch.stack([_first_row(f) for f in x[i:i + k]])):
                    errors.append((c, i, k))
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    svc.close()
    assert not any(t.is_alive() for t in threads) and errors == []
    s = svc.stats
    assert s.requests == 400 and s.errors == 0
    assert sum(c.shape[0] for c in stub.calls) == s.faces + s.padded_faces
    assert s.batches == len(stub.calls) < 400


# ---------------------------------------------------- against ffrnet_tpu


@pytest.fixture(scope="module")
def models():
    """The JAX package's FFRNet.random(0) and the port holding its weights."""
    jm = JaxFFRNet.random(seed=0)
    enc_p, enc_s, rec_p, rec_s = jax.device_get(
        (jm.enc_params, jm.enc_state, jm.rec_params, jm.rec_state))
    enc = build_backbone()
    enc.load_state_dict(backbone_state_dict(enc_p, enc_s))
    rec = build_recnet()
    rec.load_state_dict(recnet_state_dict(rec_p, rec_s))
    return jm, TorchFFRNet(enc, rec, RecNetConfig(), "cpu").prepare()


@pytest.fixture(scope="module")
def servers(models):
    """(JAX base URL, port base URL, port service, port server), each
    service with one bucket of 8."""
    jm, tm = models
    jsvc = JaxService(jm, max_batch=8, max_delay_s=0.0, buckets=(8,))
    tsvc = EmbeddingService(tm, max_batch=8, max_delay_s=0.0, buckets=(8,))
    jsrv, tsrv = JaxHTTPServer(jsvc).start(), EmbeddingHTTPServer(tsvc).start()
    yield f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{tsrv.port}", tsvc, tsrv
    for srv in (jsrv, tsrv):
        srv.close()
    jsvc.close()
    tsvc.close()


def _post(base, path, body, headers=None):
    """(status, body bytes) of one POST."""
    req = urllib.request.Request(base + path, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _f32(x):
    return np.ascontiguousarray(x, "<f4").tobytes()


def test_service_matches_jax_service(models):
    jm, tm = models
    x = _faces(8, 21)
    with JaxService(jm, max_batch=8, max_delay_s=0.05, buckets=(8,)) as jsvc:
        jouts = [f.result(WAIT) for f in [jsvc.submit(x[:3]), jsvc.submit(x[3:])]]
    with EmbeddingService(tm, max_batch=8, max_delay_s=0.05, buckets=(8,)) as tsvc:
        touts = [f.result(WAIT) for f in [tsvc.submit(x[:3]), tsvc.submit(x[3:])]]
    for (jr, jc), (tr, tc) in zip(jouts, touts):
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **EMB_TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **EMB_TOL)
    # a padded bucket's real rows equal a direct embed of the same faces
    raw, rect = tm.embed(x[:3])
    np.testing.assert_allclose(touts[0][0].numpy(), raw.numpy(), atol=1e-6)
    np.testing.assert_allclose(touts[0][1].numpy(), rect.numpy(), atol=1e-6)


def test_embed_and_verify_match_jax(servers):
    jbase, tbase, _, _ = servers
    x, u8 = _faces(6, 22), _u8(2, 23)
    for body, hdr, n in ((_f32(x), {}, 6), (u8.tobytes(), {"X-Input-Dtype": "uint8"}, 2)):
        (jc, jb), (tc, tb) = _post(jbase, "/embed", body, hdr), _post(tbase, "/embed", body, hdr)
        assert jc == tc == 200
        np.testing.assert_allclose(np.frombuffer(tb, "<f4").reshape(2, n, 512),
                                   np.frombuffer(jb, "<f4").reshape(2, n, 512), **EMB_TOL)
    (jc, jb), (tc, tb) = _post(jbase, "/verify", _f32(x)), _post(tbase, "/verify", _f32(x))
    assert jc == tc == 200
    np.testing.assert_allclose(np.frombuffer(tb, "<f4"), np.frombuffer(jb, "<f4"), **VERIFY_TOL)
    assert np.frombuffer(tb, "<f4").shape == (3,)


def test_enroll_identify_match_jax(servers, models):
    """Enroll in two requests (capacity 8 -> 16), one face under two labels;
    identify: labels equal (the duplicate by lower index), scores within
    2e-6; an enroll -> identify -> enroll cycle from the HTTP threads."""
    jbase, tbase, tsvc, tsrv = servers
    x = _faces(10, 24)
    x[9] = x[2]                          # the same face under "id2" and "id9"
    labels = [f"id{i}" for i in range(10)]
    steps = [("/enroll", x[:6], {"X-Labels": ",".join(labels[:6])}),
             ("/identify", x[2:5], {"X-Top-K": "2"}),
             ("/enroll", x[6:], {"X-Labels-Json": json.dumps(labels[6:])}),
             ("/identify", np.concatenate([x[2:5], x[9:]]), {"X-Top-K": "3"})]
    for path, faces, hdr in steps:
        (jc, jb), (tc, tb) = (_post(b, path, _f32(faces), hdr) for b in (jbase, tbase))
        assert jc == tc == 200, (path, tb)
        jr, tr = json.loads(jb), json.loads(tb)
        if path == "/enroll":
            assert tr == jr
        else:
            assert tr["labels"] == jr["labels"]
            np.testing.assert_allclose(tr["scores"], jr["scores"], **IDENTIFY_TOL)
    assert tr["labels"][0][:2] == ["id2", "id9"] and tr["labels"][3][:2] == ["id2", "id9"]
    assert tr["scores"][0][0] == tr["scores"][0][1]
    # the snapshot warm-starts a new server that identifies without enrolling
    snap = tsrv.gallery()
    assert snap.labels == labels and snap.embeddings.shape == (10, 512)
    with EmbeddingHTTPServer(tsvc, gallery=snap) as srv2:
        code, body = _post(f"http://127.0.0.1:{srv2.port}", "/identify", _f32(x[7:9]))
        assert code == 200 and [r[0] for r in json.loads(body)["labels"]] == ["id7", "id8"]
        assert srv2.gallery().embeddings.equal(snap.embeddings)


def test_status_codes_match_jax(models):
    """The JAX front's status codes on the same malformed requests: bad
    dtype, malformed / chunked length, partial faces, 413 before reading,
    409 on an empty gallery or k too large, label mismatches, 404."""
    jm, tm = models
    x = _faces(3, 25)
    cases = [
        ("/embed", b"xx", {}),
        ("/embed", _u8(1, 0).tobytes()[:-1], {"X-Input-Dtype": "uint8"}),
        ("/embed", _u8(1, 0).tobytes(), {"X-Input-Dtype": "int16"}),
        ("/embed", _f32(x), {}),                        # 3 faces > max_request_faces=2
        ("/identify", _f32(x[:1]), {}),                 # empty gallery
        ("/enroll", _f32(x[:2]), {"X-Labels": "only_one"}),
        ("/enroll", _f32(x[:1]), {"X-Labels": "smith, jane"}),
        ("/enroll", _f32(x[:2]), {"X-Labels-Json": "{notalist}"}),
        ("/enroll", _f32(x[:2]), {"X-Labels-Json": json.dumps(["smith, jane", "ü"])}),
        ("/identify", _f32(x[:1]), {"X-Top-K": "two"}),
        ("/identify", _f32(x[:1]), {"X-Top-K": "3"}),   # k > gallery size
        ("/identify", _f32(x[:1]), {"X-Top-K": "0"}),
        ("/identify", _f32(x[:1]), {}),
        ("/verify", _f32(x[:1]), {}),                   # odd count
        ("/nowhere", _f32(x[:1]), {}),
    ]
    got = {}
    for name, svc_cls, srv_cls, model in (("jax", JaxService, JaxHTTPServer, jm),
                                          ("torch", EmbeddingService, EmbeddingHTTPServer, tm)):
        svc = svc_cls(model, max_batch=8, max_delay_s=0.0, buckets=(8,))
        with srv_cls(svc, max_request_faces=2) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            got[name] = [_post(base, p, b, h) for p, b, h in cases]
            got[name].append(_raw_statuses(srv.port))
        svc.close()
    codes = [[c for c, _ in got[k][:-1]] for k in ("jax", "torch")]
    assert codes[0] == codes[1]
    assert codes[1] == [400, 400, 400, 413, 409, 400, 400, 400, 200, 400, 409, 409, 200, 400, 404]
    assert b"X-Labels-Json" in got["torch"][6][1]
    assert json.loads(got["torch"][12][1])["labels"] == [["smith, jane"]]
    assert got["jax"][-1] == got["torch"][-1] == [b"400", b"400", 1]


def _raw_statuses(port):
    """[status of a malformed Content-Length, status of a chunked body,
    number of responses on the chunked connection]: the chunked bytes must
    not be parsed as a second request."""

    def raw_request(req_bytes):
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(req_bytes)
            data = b""
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    return data
                data += chunk

    bad_len = raw_request(b"POST /embed HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n")
    chunked = raw_request(b"POST /embed HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked"
                          b"\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
    return [bad_len.split(b"\r\n", 1)[0].split()[1], chunked.split(b"\r\n", 1)[0].split()[1],
            chunked.count(b"HTTP/1.")]


def test_close_before_start_and_stats():
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.0)
    t0 = time.time()
    EmbeddingHTTPServer(svc).close()     # must not wait for serve_forever
    assert time.time() - t0 < 5.0
    with EmbeddingHTTPServer(svc) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        assert urllib.request.urlopen(base + "/healthz", timeout=WAIT).read() == b"ok"
        code, _ = _post(base, "/embed", _f32(_faces(20, 26)))  # submitted as 8 + 8 + 4
        assert code == 200
        code, _ = _post(base, "/embed", _f32(_faces(3, 26)))   # padded to 4
        assert code == 200
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=WAIT).read())
    svc.close()
    assert stats == {"requests": 4, "faces": 23, "batches": 4, "errors": 0,
                     "padded_faces": 1, "mean_batch": 23 / 4}


def test_bf16_results_cross_the_wire_as_float32():
    """A bf16 model's embeddings are widened to float32 before the bytes."""

    class Bf16Stub(Stub):
        dtype = torch.bfloat16

        def embed(self, x):
            raw, rect = super().embed(x)
            return raw.to(torch.bfloat16), rect.to(torch.bfloat16)

    svc = EmbeddingService(Bf16Stub(), max_batch=4, max_delay_s=0.0)
    x = _faces(2, 27)
    with EmbeddingHTTPServer(svc) as srv:
        code, body = _post(f"http://127.0.0.1:{srv.port}", "/embed", _f32(x))
    svc.close()
    assert code == 200 and len(body) == 2 * 2 * 512 * 4
    want = torch.stack([_first_row(f) for f in x]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.frombuffer(body, "<f4").reshape(2, 2, 512)[0], want)


def test_gallery_survives_a_snapshot_and_padding():
    """Gallery rows beyond the live count never score, and a gallery
    loaded from disk warm-starts the server."""
    stub = Stub()
    svc = EmbeddingService(stub, max_batch=8, max_delay_s=0.0)
    emb = torch.from_numpy(np.random.default_rng(28).standard_normal((3, 512)).astype(np.float32))
    with EmbeddingHTTPServer(svc, gallery=Gallery(emb, ["a", "b", "c"])) as srv:
        assert srv._gallery_emb.shape == (8, 512)
        probe = np.zeros((1, 112, 112, 3), np.float32)
        probe.reshape(-1)[:512] = emb[1].numpy()       # the stub's raw row is this
        code, body = _post(f"http://127.0.0.1:{srv.port}", "/identify", _f32(probe),
                           {"X-Top-K": "3"})
    svc.close()
    res = json.loads(body)
    assert code == 200 and res["labels"][0][0] == "b" and sorted(res["labels"][0]) == ["a", "b", "c"]
    assert all(s > -2.0 for s in res["scores"][0])
