"""The serving plane's options on the port's Daemon, held against a
keto_tpu Daemon on the same requests (tests/test_serve_options.py's
TestCORS, TestTLS, TestDirectGRPCListener and TestPidFile, ported):

  - CORS (`serve.<kind>.cors`): for an allowed Origin every answer, error
    and 204 included, carries the Access-Control-Allow-* headers and
    `Vary: Origin`; an OPTIONS preflight is a 204 with them; a disallowed
    or missing Origin, or no config, gets none. Status, body and headers
    (all but Server and Date) equal keto_tpu's;
  - TLS (`serve.<kind>.tls`): REST and gRPC over one TLS port, read and
    write, equal to keto_tpu's answers; several requests on one kept-alive
    TLS connection and a request body spanning many TLS records; plaintext
    against the port fails, and only that connection;
  - the direct gRPC listener (`serve.<kind>.grpc`) beside the muxed port,
    off when unconfigured, and inheriting the kind's TLS (plaintext
    against it fails);
  - the pid file: written with this pid on start, removed on a clean
    stop, left alone when another pid owns it, and `serve --pid-file`.

The certificate is made with `openssl req -x509`. Every wait is bounded.
Tolerance: exact equality.
"""

import http.client
import json
import os
import signal
import ssl
import subprocess
import sys
import urllib.error
import urllib.parse
import urllib.request

import grpc
import pytest

from keto_tpu.api.daemon import Daemon as JDaemon
from keto_tpu.config import Config as JConfig
from keto_tpu.ketoapi import RelationTuple as JTuple
from keto_tpu.registry import Registry as JRegistry

from keto_tpu_torch.api.daemon import Daemon as TDaemon
from keto_tpu_torch.api.descriptors import CHECK_SERVICE, WRITE_SERVICE, pb
from keto_tpu_torch.config import Config as TConfig
from keto_tpu_torch.ketoapi import RelationTuple
from keto_tpu_torch.registry import Registry as TRegistry

from test_torch_grpc import small_pools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30
NAMESPACES = [{"name": "files"}]
TUPLES = ["files:doc#owner@alice", "files:doc#owner@bob", "files:memo#owner@carol"]
LISTEN = {"read": {"host": "127.0.0.1", "port": 0}, "write": {"host": "127.0.0.1", "port": 0},
          "metrics": {"host": "127.0.0.1", "port": 0}}
APP = "https://app.example"
CHECK = {"namespace": "files", "object": "doc", "relation": "owner", "subject_id": "alice"}
CHECK_PATH = f"/{CHECK_SERVICE}/Check"
TRANSACT_PATH = f"/{WRITE_SERVICE}/TransactRelationTuples"


def make_pair(serve=None, pid_files=(None, None)):
    """A port and a keto_tpu daemon over equal stores, `serve` merged per
    listener kind into the config."""
    merged = {k: {**v, **(serve or {}).get(k, {})} for k, v in LISTEN.items()}
    cfg = {"dsn": "memory", "namespaces": NAMESPACES, "serve": merged}
    treg = TRegistry(TConfig(cfg), device="cpu")
    jreg = JRegistry(JConfig(cfg))
    treg.relation_tuple_manager().write_relation_tuples(
        [RelationTuple.from_string(s) for s in TUPLES])
    jreg.relation_tuple_manager().write_relation_tuples([JTuple.from_string(s) for s in TUPLES])
    tdaemon = TDaemon(treg, pid_file=pid_files[0])
    jdaemon = JDaemon(jreg, pid_file=pid_files[1])
    with small_pools():
        tdaemon.start()
        jdaemon.start()
    return tdaemon, jdaemon


def stop(*daemons):
    for d in daemons:
        d.stop(grace=1.0)


def call(port, method, path, params=None, body=None, headers=None, context=None):
    """(status, JSON body or None, headers but Server and Date); https
    with a TLS `context`."""
    scheme = "https" if context is not None else "http"
    url = f"{scheme}://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S, context=context) as r:
            status, payload, hdrs = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, payload, hdrs = e.code, e.read(), e.headers
    kept = {k: v for k, v in hdrs.items() if k not in ("Server", "Date")}
    return status, json.loads(payload) if payload else None, kept


def grpc_call(target, path, msg, credentials=None):
    """(code, response bytes, details) of one unary call."""
    ch = grpc.secure_channel(target, credentials) if credentials is not None \
        else grpc.insecure_channel(target)
    try:
        resp = ch.unary_unary(path)(msg.SerializeToString(), timeout=10)
        return "OK", resp, ""
    except grpc.RpcError as e:
        return e.code().name, None, e.details()
    finally:
        ch.close()


def check_msg(obj="doc", sub="alice"):
    req = pb.CheckRequest()
    req.tuple.namespace, req.tuple.object, req.tuple.relation = "files", obj, "owner"
    req.tuple.subject.id = sub
    return req


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    """A self-signed certificate for 127.0.0.1: (cert path, key path)."""
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
         "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


def client_context(cert):
    return ssl.create_default_context(cafile=cert[0])


def channel_credentials(cert):
    with open(cert[0], "rb") as f:
        return grpc.ssl_channel_credentials(f.read())


# -- CORS ---------------------------------------------------------------------------------

CORS = {"read": {"cors": {"enabled": True, "allowed_origins": [APP]}},
        "write": {"cors": {"enabled": True, "allowed_origins": ["*"],
                           "allowed_methods": ["PUT", "DELETE"],
                           "allowed_headers": ["X-Custom"]}}}


@pytest.fixture(scope="module")
def cors_daemons():
    tdaemon, jdaemon = make_pair(CORS)
    yield tdaemon, jdaemon
    stop(tdaemon, jdaemon)


READ_CASES = {
    "allowed_origin": ("GET", "/relation-tuples/check/openapi", CHECK, None, {"Origin": APP}),
    "allowed_origin_403": ("GET", "/relation-tuples/check", {**CHECK, "subject_id": "eve"},
                           None, {"Origin": APP}),
    "preflight": ("OPTIONS", "/relation-tuples/check", None, None,
                  {"Origin": APP, "Access-Control-Request-Method": "POST"}),
    "preflight_any_path": ("OPTIONS", "/nowhere", None, None, {"Origin": APP}),
    "preflight_disallowed": ("OPTIONS", "/relation-tuples/check", None, None,
                             {"Origin": "https://evil.example"}),
    "preflight_no_origin": ("OPTIONS", "/relation-tuples/check", None, None, None),
    "disallowed_origin": ("GET", "/relation-tuples/check/openapi", CHECK, None,
                          {"Origin": "https://evil.example"}),
    "no_origin": ("GET", "/relation-tuples/check/openapi", CHECK, None, None),
    "error_answer": ("GET", "/nowhere", None, None, {"Origin": APP}),
    "bad_request": ("GET", "/relation-tuples/list-objects", {"namespace": "files"}, None,
                    {"Origin": APP}),
    "batch_post": ("POST", "/relation-tuples/check/batch", None,
                   {"tuples": [CHECK, {**CHECK, "subject_id": "eve"}]}, {"Origin": APP}),
    "health": ("GET", "/health/ready", None, None, {"Origin": APP}),
    "version": ("GET", "/version", None, None, {"Origin": APP}),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_cors_read_listener_equal_keto_tpu(cors_daemons, case):
    method, path, params, body, headers = READ_CASES[case]
    got = call(cors_daemons[0].read_port, method, path, params, body, headers)
    want = call(cors_daemons[1].read_port, method, path, params, body, headers)
    assert got == want, case
    allowed = headers is not None and headers.get("Origin") == APP
    assert (got[2].get("Access-Control-Allow-Origin") == APP) == allowed, got
    if allowed:
        assert got[2]["Vary"] == "Origin"
        assert got[2]["Access-Control-Allow-Methods"] == "GET, POST, PUT, PATCH, DELETE, OPTIONS"
        assert got[2]["Access-Control-Allow-Headers"] == "Authorization, Content-Type"
    if method == "OPTIONS":
        assert got[0] == 204 and got[1] is None


def test_cors_write_listener_equal_keto_tpu(cors_daemons):
    """The write listener's own config: a wildcard origin, its methods and
    headers, on a 201, a 204, a 404 and a preflight."""
    origin = {"Origin": "https://other.example"}
    grant = {"namespace": "files", "object": "memo", "relation": "owner", "subject_id": "dan"}
    for method, path, params, body in (
            ("OPTIONS", "/admin/relation-tuples", None, None),
            ("PUT", "/admin/relation-tuples", None, grant),
            ("DELETE", "/admin/relation-tuples", {"namespace": "files", "object": "memo",
                                                  "relation": "owner", "subject_id": "dan"},
             None),
            ("PUT", "/admin/relation-tuples", None, {**grant, "namespace": "ghost"})):
        got = call(cors_daemons[0].write_port, method, path, params, body, origin)
        want = call(cors_daemons[1].write_port, method, path, params, body, origin)
        assert got == want, (method, body)
        assert got[2]["Access-Control-Allow-Origin"] == "*"
        assert got[2]["Access-Control-Allow-Methods"] == "PUT, DELETE"
        assert got[2]["Access-Control-Allow-Headers"] == "X-Custom"
    assert [got[0]] == [404]


@pytest.mark.parametrize("cors", [None, {"enabled": False, "allowed_origins": [APP]}],
                         ids=["unset", "disabled"])
def test_cors_off_equal_keto_tpu(cors):
    tdaemon, jdaemon = make_pair({"read": {"cors": cors}} if cors is not None else None)
    try:
        for method in ("GET", "OPTIONS"):
            got = call(tdaemon.read_port, method, "/relation-tuples/check/openapi", CHECK,
                       headers={"Origin": APP})
            want = call(jdaemon.read_port, method, "/relation-tuples/check/openapi", CHECK,
                        headers={"Origin": APP})
            assert got == want
            assert not any(k.startswith("Access-Control") for k in got[2])
        assert got[0] == 204
    finally:
        stop(tdaemon, jdaemon)


# -- TLS ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls_daemons(cert):
    tls = {"tls": {"cert_path": cert[0], "key_path": cert[1]}}
    tdaemon, jdaemon = make_pair({"read": tls, "write": tls})
    yield tdaemon, jdaemon
    stop(tdaemon, jdaemon)


def test_rest_and_grpc_over_one_tls_port(tls_daemons, cert):
    ctx, creds = client_context(cert), channel_credentials(cert)
    tdaemon, jdaemon = tls_daemons
    for params in (CHECK, {**CHECK, "subject_id": "eve"}):
        got = call(tdaemon.read_port, "GET", "/relation-tuples/check/openapi", params,
                   context=ctx)
        assert got == call(jdaemon.read_port, "GET", "/relation-tuples/check/openapi",
                           params, context=ctx)
    assert got[:2] == (200, {"allowed": False})
    for msg in (check_msg(), check_msg(sub="eve"), check_msg(obj="memo", sub="carol")):
        got = grpc_call(f"127.0.0.1:{tdaemon.read_port}", CHECK_PATH, msg, creds)
        assert got == grpc_call(f"127.0.0.1:{jdaemon.read_port}", CHECK_PATH, msg, creds)
        assert got[0] == "OK"
    assert pb.CheckResponse.FromString(got[1]).allowed


def test_writes_over_tls(tls_daemons, cert):
    """A PUT over https and a Transact over gRPC on the TLS write port,
    each then seen by a check at its token."""
    ctx, creds = client_context(cert), channel_credentials(cert)
    tdaemon, jdaemon = tls_daemons
    grant = {"namespace": "files", "object": "report", "relation": "owner", "subject_id": "erin"}
    got = call(tdaemon.write_port, "PUT", "/admin/relation-tuples", body=grant, context=ctx)
    assert got == call(jdaemon.write_port, "PUT", "/admin/relation-tuples", body=grant,
                       context=ctx)
    assert got[0] == 201
    token = got[2]["X-Keto-Snaptoken"]
    params = {**grant, "snaptoken": token}
    got = call(tdaemon.read_port, "GET", "/relation-tuples/check", params, context=ctx)
    assert got == call(jdaemon.read_port, "GET", "/relation-tuples/check", params, context=ctx)
    assert got[:2] == (200, {"allowed": True})
    req = pb.TransactRelationTuplesRequest()
    d = req.relation_tuple_deltas.add()
    d.action = 1
    d.relation_tuple.namespace, d.relation_tuple.object = "files", "plan"
    d.relation_tuple.relation, d.relation_tuple.subject.id = "owner", "finn"
    got = grpc_call(f"127.0.0.1:{tdaemon.write_port}", TRANSACT_PATH, req, creds)
    assert got == grpc_call(f"127.0.0.1:{jdaemon.write_port}", TRANSACT_PATH, req, creds)
    token = pb.TransactRelationTuplesResponse.FromString(got[1]).snaptokens[0]
    msg = check_msg(obj="plan", sub="finn")
    msg.snaptoken = token
    got = grpc_call(f"127.0.0.1:{tdaemon.read_port}", CHECK_PATH, msg, creds)
    assert got == grpc_call(f"127.0.0.1:{jdaemon.read_port}", CHECK_PATH, msg, creds)
    assert pb.CheckResponse.FromString(got[1]).allowed


def test_tls_keep_alive_and_a_body_across_records(tls_daemons, cert):
    """Three requests on one kept-alive TLS connection (the REST server
    reads each through the mux's hand-over), then a batch body of ~70 KB,
    more than four TLS records."""
    ctx = client_context(cert)
    out = {}
    big = {"tuples": [{**CHECK, "subject_id": f"user-{i:05d}-" + "x" * 48} for i in range(900)]
           + [CHECK]}
    for daemon in tls_daemons:
        conn = http.client.HTTPSConnection("127.0.0.1", daemon.read_port, context=ctx,
                                           timeout=WAIT_S)
        answers = []
        try:
            for _ in range(3):
                conn.request("GET", "/relation-tuples/check/openapi?" +
                             urllib.parse.urlencode(CHECK))
                r = conn.getresponse()
                answers.append((r.status, json.loads(r.read())))
            body = json.dumps(big).encode()
            assert len(body) > 4 * 16384
            conn.request("POST", "/relation-tuples/check/batch", body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            answers.append((r.status, json.loads(r.read())))
        finally:
            conn.close()
        out[daemon] = answers
    got, want = out.values()
    assert got == want
    assert got[0] == (200, {"allowed": True})
    results = got[3][1]["results"]
    assert len(results) == 901 and results[-1] == {"allowed": True} and not results[0]["allowed"]


def test_plaintext_against_tls_ports_fails_alone(tls_daemons, cert):
    """Plain HTTP and plaintext gRPC against a TLS port fail; a failed
    handshake closes that connection alone, and TLS goes on answering."""
    ctx, creds = client_context(cert), channel_credentials(cert)
    for daemon in tls_daemons:
        for port in (daemon.read_port, daemon.write_port):
            with pytest.raises((urllib.error.URLError, ConnectionError, http.client.HTTPException)):
                call(port, "GET", "/version")
            code, _resp, _details = grpc_call(f"127.0.0.1:{port}", CHECK_PATH, check_msg())
            assert code == "UNAVAILABLE"
        got = call(daemon.read_port, "GET", "/version", context=ctx)
        assert got[0] == 200
        assert grpc_call(f"127.0.0.1:{daemon.read_port}", CHECK_PATH, check_msg(),
                         creds)[0] == "OK"


# -- the direct gRPC listener -----------------------------------------------------------------

DIRECT = {"grpc": {"host": "127.0.0.1", "port": 0}}


def test_direct_and_muxed_ports_both_serve():
    tdaemon, jdaemon = make_pair({"read": DIRECT, "write": DIRECT})
    try:
        assert tdaemon.read_grpc_port not in (None, tdaemon.read_port)
        assert tdaemon.write_grpc_port not in (None, tdaemon.write_port)
        for msg in (check_msg(), check_msg(sub="eve")):
            want = grpc_call(f"127.0.0.1:{jdaemon.read_grpc_port}", CHECK_PATH, msg)
            for port in (tdaemon.read_grpc_port, tdaemon.read_port):
                assert grpc_call(f"127.0.0.1:{port}", CHECK_PATH, msg) == want
    finally:
        stop(tdaemon, jdaemon)


def test_direct_listener_unconfigured_stays_off():
    tdaemon, jdaemon = make_pair()
    try:
        for d in (tdaemon, jdaemon):
            assert d.read_grpc_port is None and d.write_grpc_port is None
    finally:
        stop(tdaemon, jdaemon)


def test_direct_port_inherits_tls(cert):
    """A TLS kind's direct gRPC listeners serve TLS too, read and write;
    plaintext against them fails on both daemons."""
    tls = {"tls": {"cert_path": cert[0], "key_path": cert[1]}, **DIRECT}
    tdaemon, jdaemon = make_pair({"read": tls, "write": tls})
    creds = channel_credentials(cert)
    try:
        got = grpc_call(f"127.0.0.1:{tdaemon.read_grpc_port}", CHECK_PATH, check_msg(), creds)
        assert got == grpc_call(f"127.0.0.1:{jdaemon.read_grpc_port}", CHECK_PATH,
                                check_msg(), creds)
        assert got[0] == "OK" and pb.CheckResponse.FromString(got[1]).allowed
        for d in (tdaemon, jdaemon):
            for port in (d.read_grpc_port, d.write_grpc_port):
                assert grpc_call(f"127.0.0.1:{port}", CHECK_PATH, check_msg())[0] == \
                    "UNAVAILABLE"
            assert grpc_call(f"127.0.0.1:{d.write_grpc_port}", TRANSACT_PATH,
                             pb.TransactRelationTuplesRequest(), creds)[0] == "OK"
    finally:
        stop(tdaemon, jdaemon)


# -- the pid file ---------------------------------------------------------------------------


def test_pid_file_written_on_start_removed_on_stop(tmp_path):
    files = (str(tmp_path / "port.pid"), str(tmp_path / "keto_tpu.pid"))
    tdaemon, jdaemon = make_pair(pid_files=files)
    try:
        for path in files:
            with open(path) as f:
                assert int(f.read()) == os.getpid()
    finally:
        stop(tdaemon, jdaemon)
    assert not any(os.path.exists(p) for p in files)


def test_pid_file_unconfigured_writes_nothing(tmp_path):
    tdaemon, jdaemon = make_pair()
    stop(tdaemon, jdaemon)
    assert tdaemon.pid_file is None and jdaemon.pid_file is None
    assert not os.listdir(tmp_path)


def test_pid_file_of_another_pid_left_alone(tmp_path):
    """A supervisor started a replacement onto the same path while this
    daemon ran: the stop leaves the replacement's file as it is."""
    files = (str(tmp_path / "port.pid"), str(tmp_path / "keto_tpu.pid"))
    tdaemon, jdaemon = make_pair(pid_files=files)
    try:
        for path in files:
            with open(path, "w") as f:
                f.write("424242")
    finally:
        stop(tdaemon, jdaemon)
    for path in files:
        with open(path) as f:
            assert f.read() == "424242"


def test_serve_pid_file_flag(tmp_path):
    """`python -m keto_tpu_torch serve --pid-file`: the file holds the
    process's pid while it serves and is gone after SIGTERM's clean stop."""
    cfg = {"namespaces": NAMESPACES, "serve": {"read": LISTEN["read"],
                                               "write": LISTEN["write"]}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    pid_file = tmp_path / "serve.pid"
    proc = subprocess.Popen(
        [sys.executable, "-m", "keto_tpu_torch", "serve", "--config", str(tmp_path / "cfg.json"),
         "--device", "cpu", "--pid-file", str(pid_file)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        for want in ("serving read=", "serving write="):
            line = proc.stdout.readline()
            assert line.startswith(want), line + proc.stderr.read()
        assert int(pid_file.read_text()) == proc.pid
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
        proc.stdout.close()
        proc.stderr.close()
    assert not pid_file.exists()
