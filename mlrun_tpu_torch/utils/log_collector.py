"""Client for the native C++ log collector — the port's copy of
``mlrun_tpu/utils/log_collector.py``; the daemon's source is the port's
own copy, ``mlrun_tpu_torch/csrc/log_collector.cpp``, built with g++ at
first use into the git-ignored host build root (``ops/_build.build_host``).

Reference analog: the Python gRPC client to the Go log-collector
(server/api/utils/clients/log_collector.py:71). Text/binary protocol over a
localhost TCP socket; the service uses it when MLT_LOG_COLLECTOR is set (or
a daemon can be spawned with ``ensure_daemon``), else falls back to the
Python file path in SQLiteRunDB.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Optional

from ..utils import logger

DEFAULT_PORT = 8766


class LogCollectorClient:
    def __init__(self, address: str = ""):
        address = address or os.environ.get(
            "MLT_LOG_COLLECTOR", f"127.0.0.1:{DEFAULT_PORT}")
        host, _, port = address.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or DEFAULT_PORT)

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        return sock

    @staticmethod
    def _read_line(sock: socket.socket) -> str:
        out = b""
        while not out.endswith(b"\n"):
            chunk = sock.recv(1)
            if not chunk:
                break
            out += chunk
        return out.decode().strip()

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = sock.recv(n - len(out))
            if not chunk:
                break
            out += chunk
        return out

    def _command(self, line: str, payload: bytes = b"",
                 read_payload: bool = False):
        with self._connect() as sock:
            sock.sendall(line.encode() + b"\n" + payload)
            header = self._read_line(sock)
            if header.startswith("ERR"):
                raise RuntimeError(f"log collector: {header}")
            parts = header.split()
            if read_payload:
                n = int(parts[1]) if len(parts) > 1 else 0
                return self._read_exact(sock, n)
            return int(parts[1]) if len(parts) > 1 else None

    # -- api ----------------------------------------------------------------
    def ping(self) -> bool:
        try:
            self._command("PING")
            return True
        except (OSError, RuntimeError):
            return False

    def start_log(self, project: str, uid: str, src_path: str):
        self._command(f"START {project} {uid} {src_path}")

    def start_command(self, project: str, uid: str, command: str,
                      token: str = ""):
        """Stream a subprocess's stdout into the store (pod-log streaming:
        reference server.go:880 streams the k8s pod-log API; here the
        daemon runs e.g. ``kubectl logs -f`` which carries cluster auth).

        Command streaming is token-gated — the daemon must run with
        ``--cmd-token`` (or MLT_LOGD_CMD_TOKEN) and the same token must be
        presented here (default: the MLT_LOGD_CMD_TOKEN env var)."""
        token = token or os.environ.get("MLT_LOGD_CMD_TOKEN", "")
        payload = command.encode()
        self._command(
            f"STARTCMD {project} {uid} {token or '-'} {len(payload)}",
            payload=payload)

    def start_pod_logs(self, project: str, uid: str, pod: str,
                       namespace: str = "default", container: str = "",
                       token: str = ""):
        """Collect a pod's logs via the kubectl streaming API."""
        command = f"kubectl logs -f {pod} -n {namespace}"
        if container:
            command += f" -c {container}"
        self.start_command(project, uid, command, token=token)

    def append(self, project: str, uid: str, data: bytes):
        if isinstance(data, str):
            data = data.encode()
        self._command(f"APPEND {project} {uid} {len(data)}", payload=data)

    def get_log(self, project: str, uid: str, offset: int = 0,
                size: int = -1) -> bytes:
        return self._command(f"GET {project} {uid} {offset} {size}",
                             read_payload=True)

    def get_log_size(self, project: str, uid: str) -> int:
        return self._command(f"SIZE {project} {uid}") or 0

    def stop_log(self, project: str, uid: str):
        self._command(f"STOP {project} {uid}")

    def list_in_progress(self) -> list[str]:
        data = self._command("LIST", read_payload=False)
        # LIST replies "OK <k>" then k lines; reopen for payload read
        with self._connect() as sock:
            sock.sendall(b"LIST\n")
            header = self._read_line(sock)
            count = int(header.split()[1])
            return [self._read_line(sock) for _ in range(count)]


_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "log_collector.cpp")


def binary_path() -> str:
    """Where the daemon's build lands: the host build root, keyed on the
    source and the flags (the file exists once :func:`build_binary` ran)."""
    import hashlib

    from ..ops import _build

    digest = hashlib.sha256(" ".join(_build.HOST_EXE_FLAGS).encode())
    with open(_SOURCE, "rb") as fp:
        digest.update(fp.read())
    return str(_build.HOST_BUILD_ROOT / digest.hexdigest()[:16] / "mlt-logd")


def build_binary() -> bool:
    """Compile the daemon with g++; returns availability."""
    if os.path.isfile(binary_path()):
        return True
    from ..ops import _build

    try:
        _build.build_host(_SOURCE, "mlt-logd", executable=True)
    except (_build.KernelBuildError, OSError) as exc:
        logger.warning("mlt-logd build failed", error=str(exc))
        return False
    return os.path.isfile(binary_path())


def ensure_daemon(store_dir: str, port: int = DEFAULT_PORT
                  ) -> Optional[LogCollectorClient]:
    """Start (or connect to) a local daemon; None if unavailable."""
    client = LogCollectorClient(f"127.0.0.1:{port}")
    if client.ping():
        return client
    if not build_binary():
        return None
    subprocess.Popen(
        [binary_path(), "--port", str(port), "--store-dir", store_dir],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    for _ in range(50):
        if client.ping():
            return client
        time.sleep(0.1)
    return None
