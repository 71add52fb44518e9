"""The port's Node-label bootstrap (parallel/bootstrap.py) against the JAX
package's, on the CPU, through a fake API server on loopback.

The server (``http.server`` in a thread; plain HTTP, or HTTPS with a
certificate made here by ``openssl`` for 127.0.0.1) serves Nodes by name
and records each request's path and Authorization header. Held:

- ``node_labels_from_api`` returns what the JAX ``node_labels_from_api(
  name, connection=KubeConnection(server=..., token=...))`` returns, from
  the same path with the same header, and ``discover`` gives the JAX
  ``discover``'s ``SliceTopology``;
- a 404 raises at once, a 500 after its retries, each naming status and
  path; a 503 that clears is retried through;
- ``NodeConnection.in_cluster`` reads a service-account directory (the
  token re-read at every request) and reaches the server over HTTPS
  through its CA;
- end to end: two processes with ``NODE_NAME=node-0/1`` read Nodes
  labelled ``hosts=2``, ``worker-index=0/1`` and ``coordinator=
  127.0.0.1:<free port>`` and ``bootstrap(device="cpu")`` into one gloo
  world whose ranks and size come from the labels; both examples'
  ``TPU_KAITO_BOOTSTRAP=auto`` paths run in two such processes, finding
  the server through ``KUBERNETES_SERVICE_HOST`` and a service-account
  directory.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from gpu_provisioner_tpu.parallel import bootstrap as jboot
from gpu_provisioner_tpu.runtime.rest import KubeConnection
from gpu_provisioner_tpu_torch.parallel import bootstrap as tboot
from gpu_provisioner_tpu_torch.parallel.launch import free_port

ROOT = Path(__file__).resolve().parent.parent
PREFIX = "tpu.kaito.sh/"


def _labels(worker: int, coordinator: str = "10.0.0.2:8476") -> dict:
    return {PREFIX + "accelerator": "v5e", PREFIX + "topology": "2x4",
            PREFIX + "chips": "8", PREFIX + "hosts": "2",
            PREFIX + "worker-index": str(worker),
            PREFIX + "slice-group": "group-a",
            PREFIX + "coordinator": coordinator,
            "kubernetes.io/hostname": f"node-{worker}"}


class FakeAPI:
    """Serves ``nodes`` ({name: labels}); a name in ``fail`` answers with
    its status (its first ``fail_times`` requests only, when set)."""

    def __init__(self, nodes: dict, tls: tuple = None):
        self.nodes, self.fail, self.fail_times = nodes, {}, {}
        self.seen = []
        api = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                api.seen.append((self.path,
                                 self.headers.get("Authorization")))
                name = self.path.rsplit("/", 1)[-1]
                status = api.fail.get(name)
                if status and api.fail_times.get(name, 1) > 0:
                    if name in api.fail_times:
                        api.fail_times[name] -= 1
                    return self._send(status, {"kind": "Status",
                                               "code": status})
                if (not self.path.startswith("/api/v1/nodes/")
                        or name not in api.nodes):
                    return self._send(404, {"kind": "Status", "code": 404})
                self._send(200, {"apiVersion": "v1", "kind": "Node",
                                 "metadata": {"name": name,
                                              "labels": api.nodes[name]},
                                 "spec": {}, "status": {}})

            def _send(self, status, body):
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        if tls:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*tls)
            self.server.socket = ctx.wrap_socket(self.server.socket,
                                                 server_side=True)
        self.port = self.server.server_address[1]
        self.url = f"{'https' if tls else 'http'}://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def api():
    srv = FakeAPI({"node-0": _labels(0), "node-1": _labels(1)})
    yield srv
    srv.close()


@pytest.fixture(scope="module")
def sa_dir(tmp_path_factory):
    """A service-account directory: a token and the CA (a self-signed
    certificate for 127.0.0.1, whose key the HTTPS server uses)."""
    d = tmp_path_factory.mktemp("serviceaccount")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(d / "key.pem"), "-out", str(d / "ca.crt"),
         "-days", "1", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    (d / "token").write_text("sa-token\n")
    return d


@pytest.fixture
def tls_api(sa_dir):
    srv = FakeAPI({"node-0": _labels(0), "node-1": _labels(1)},
                  tls=(sa_dir / "ca.crt", sa_dir / "key.pem"))
    yield srv
    srv.close()


def test_node_labels_match_the_jax_reader(api):
    got = asyncio.run(tboot.node_labels_from_api(
        "node-1", tboot.NodeConnection(server=api.url, token="tok")))
    port_seen = list(api.seen)
    want = asyncio.run(jboot.node_labels_from_api(
        "node-1", connection=KubeConnection(server=api.url, token="tok")))
    assert got == want == _labels(1)
    assert port_seen == api.seen[len(port_seen):] == [
        ("/api/v1/nodes/node-1", "Bearer tok")]


def test_discover_matches_the_jax_discover(api):
    env = {"NODE_NAME": "node-0", "TPU_WORKER_HOSTNAMES": "h0,h1"}
    got = asyncio.run(tboot.discover(
        env, tboot.NodeConnection(server=api.url, token="tok")))
    want = asyncio.run(jboot.discover(
        env, connection=KubeConnection(server=api.url, token="tok")))
    assert vars(got) == vars(want)
    assert (got.hosts, got.worker_index, got.coordinator) == (
        2, 0, "10.0.0.2:8476")
    assert got.distributed_init_args() == {
        "init_method": "tcp://10.0.0.2:8476", "world_size": 2, "rank": 0}


def test_a_missing_node_raises_at_once(api):
    conn = tboot.NodeConnection(server=api.url, token="tok")
    with pytest.raises(tboot.NodeReadError,
                       match="GET /api/v1/nodes/node-9: HTTP 404"):
        asyncio.run(tboot.node_labels_from_api("node-9", conn))
    assert len(api.seen) == 1


def test_a_server_error_raises_after_its_retries(api):
    api.fail["node-0"] = 500
    conn = tboot.NodeConnection(server=api.url, token="tok")
    with pytest.raises(tboot.NodeReadError,
                       match="GET /api/v1/nodes/node-0: HTTP 500 .* after 3 "
                             "retries"):
        asyncio.run(tboot.node_labels_from_api("node-0", conn))
    assert len(api.seen) == tboot.RETRIES + 1


def test_a_transient_error_is_retried_through(api):
    api.fail["node-0"], api.fail_times["node-0"] = 503, 2
    conn = tboot.NodeConnection(server=api.url, token="tok")
    assert asyncio.run(tboot.node_labels_from_api("node-0", conn)) == \
        _labels(0)
    assert len(api.seen) == 3


def test_in_cluster_reads_the_service_account(tls_api, sa_dir, monkeypatch):
    """The in-cluster connection: https at KUBERNETES_SERVICE_HOST/_PORT,
    the service account's token (re-read at every request) and its CA,
    which signs the server's certificate."""
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(tls_api.port))
    monkeypatch.setattr(tboot, "SA_DIR", str(sa_dir))
    conn = tboot.NodeConnection.in_cluster()
    assert conn == tboot.NodeConnection(
        server=tls_api.url, token_file=f"{sa_dir}/token",
        ca_file=f"{sa_dir}/ca.crt")
    assert asyncio.run(tboot.node_labels_from_api("node-0", conn)) == \
        _labels(0)
    (sa_dir / "token").write_text("rotated\n")
    asyncio.run(tboot.node_labels_from_api("node-1", conn))
    assert [h for _, h in tls_api.seen] == ["Bearer sa-token",
                                            "Bearer rotated"]
    (sa_dir / "token").write_text("sa-token\n")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    with pytest.raises(tboot.NodeReadError, match="not in a cluster"):
        tboot.NodeConnection.in_cluster()


def _world_nodes(srv):
    """Two Nodes of one 2-host slice whose coordinator is a free loopback
    port."""
    coordinator = f"127.0.0.1:{free_port()}"
    srv.nodes.update({f"node-{i}": _labels(i, coordinator)
                      for i in range(2)})


def _pods(code: str, srv, sa_dir, extra_env=None, timeout=240):
    """Two processes running ``code`` with ``NODE_NAME=node-0/1``, the
    in-cluster variables pointing at ``srv`` and the service-account
    directory as argv[1]: (returncode, stdout, stderr) of each. They run
    at nice 19, as launch.spawn_ranks runs CPU ranks, so that they yield
    the host's cores to the suite's timing-sensitive tests."""
    env = {**os.environ, "KUBERNETES_SERVICE_HOST": "127.0.0.1",
           "KUBERNETES_SERVICE_PORT": str(srv.port),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
               "PYTHONPATH", ""), **(extra_env or {})}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(sa_dir)], cwd=ROOT,
        env={**env, "NODE_NAME": f"node-{i}"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, preexec_fn=lambda: os.nice(19))
        for i in range(2)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# the pods find the server as a pod does: the in-cluster connection, with
# the service-account directory of this test in place of the fixed one
BOOTSTRAP = """
import asyncio, json, sys
import torch, torch.distributed as dist
from gpu_provisioner_tpu_torch.parallel import bootstrap
bootstrap.SA_DIR = sys.argv[1]
topo = asyncio.run(bootstrap.bootstrap(device="cpu"))
x = torch.ones(1) * (dist.get_rank() + 1)
dist.all_reduce(x)
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "worker": topo.worker_index, "sum": x.item(),
                  "backend": dist.get_backend()}))
dist.destroy_process_group()
"""


def test_two_pods_bootstrap_one_world_from_their_nodes(tls_api, sa_dir):
    _world_nodes(tls_api)
    res = _pods(BOOTSTRAP, tls_api, sa_dir)
    assert all(rc == 0 for rc, _, _ in res), res
    got = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in res]
    assert got == [{"rank": i, "world": 2, "worker": i, "sum": 3.0,
                    "backend": "gloo"} for i in range(2)]
    assert sorted(p for p, _ in tls_api.seen) == [
        "/api/v1/nodes/node-0", "/api/v1/nodes/node-1"]


EXAMPLE = """
import runpy, sys
from gpu_provisioner_tpu_torch.parallel import bootstrap
bootstrap.SA_DIR = sys.argv[1]
sys.argv = [sys.argv[2], "--device", "cpu"]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


@pytest.mark.parametrize("example", ["train_resume", "serve"])
def test_example_bootstraps_from_its_nodes(tls_api, sa_dir, example):
    """The example's TPU_KAITO_BOOTSTRAP=auto path: each process is one
    rank of the world its Node's labels describe; rank 0 prints the
    example's lines, rank 1 nothing."""
    _world_nodes(tls_api)
    code = EXAMPLE.replace(
        "sys.argv[2]",
        f"'gpu_provisioner_tpu_torch.examples.{example}'")
    res = _pods(code, tls_api, sa_dir, {"TPU_KAITO_BOOTSTRAP": "auto"})
    assert all(rc == 0 for rc, _, _ in res), res
    (_, out0, _), (_, out1, _) = res
    assert out1.strip() == ""
    assert out0.rstrip().endswith("done")
    if example == "serve":
        assert "'model': 2" in out0.splitlines()[0]
        assert "multi-turn cache length: 34" in out0
    else:
        assert "'data': 2" in out0.splitlines()[0]
        assert "checkpointed at step 3" in out0
        resumed = next(x for x in out0.splitlines()
                       if x.startswith("resuming on mesh"))
        assert "'model': 2" in resumed and "step 6 (resumed)" in out0
