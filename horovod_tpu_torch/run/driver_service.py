"""Driver/task services: NIC discovery across hosts (a copy of
``horovod_tpu/run/driver_service.py``).

Reference: horovod/run/driver/driver_service.py:128-197 + task services —
the launcher starts a lightweight task server on every host over ssh, task
``i`` probes task ``i+1``'s candidate addresses, and the driver intersects
the interfaces that worked, yielding the NICs every host can reach: the
ones to give ``NCCL_SOCKET_IFNAME`` / ``GLOO_SOCKET_IFNAME`` and to bind
the ``torch.distributed`` coordinator on (``HVDTPU_COORDINATOR``).

Design here: a :class:`TaskServer` (plain TCP, JSON protocol) serves its
host's candidate addresses and performs connect-probes on request; the
driver runs ring-probing — host ``i`` verifies host ``i+1``'s candidates —
and intersects the interface names that were reachable everywhere.
Payloads are HMAC-signed with a per-job secret like the reference's
(horovod/run/common/util/secret.py), so a stray process can't inject
addresses.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets as _secrets
import socket
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "local_addresses",
    "TaskServer",
    "probe",
    "discover_common_interfaces",
    "make_secret",
]


def make_secret() -> str:
    """Per-job HMAC key (reference secret.make_secret_key)."""
    return _secrets.token_hex(16)


def _sign(key: str, payload: bytes) -> bytes:
    return hmac.new(key.encode(), payload, hashlib.sha256).hexdigest().encode()


def _pack(key: str, obj) -> bytes:
    payload = json.dumps(obj).encode()
    return _sign(key, payload) + b"\n" + payload + b"\n"


def _unpack(key: str, raw: bytes):
    sig, _, payload = raw.partition(b"\n")
    payload = payload.rstrip(b"\n")
    if not hmac.compare_digest(sig, _sign(key, payload)):
        raise ValueError("bad message signature (wrong or missing job secret)")
    return json.loads(payload.decode())


def local_addresses() -> Dict[str, List[str]]:
    """Interface -> IPv4 addresses, loopback excluded (reference
    driver_service get_local_addresses via psutil.net_if_addrs)."""
    import psutil  # noqa: PLC0415  (baked into the reference's deps too)

    out: Dict[str, List[str]] = {}
    for iface, addrs in psutil.net_if_addrs().items():
        for a in addrs:
            if a.family == socket.AF_INET and not a.address.startswith("127."):
                out.setdefault(iface, []).append(a.address)
    return out


class TaskServer:
    """Per-host prober (reference task_service): answers
    ``addresses`` (its candidate NICs) and ``probe`` (connect to a list of
    host:port candidates, report which worked)."""

    def __init__(self, key: str, port: int = 0):
        self.key = key
        self._srv = socket.create_server(("", port))
        self.port = self._srv.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with conn:
                # Any per-request failure (malformed payload, client gone
                # mid-sendall) must not kill the accept loop — the server
                # would silently stop answering while still accepting.
                try:
                    with conn.makefile("rb") as f:
                        req = _unpack(self.key, f.readline() + f.readline())
                    if req.get("op") == "addresses":
                        resp = {"addresses": local_addresses()}
                    elif req.get("op") == "probe":
                        ok = []
                        for iface, addr, port in req["candidates"]:
                            if _can_connect(addr, port):
                                ok.append(iface)
                        resp = {"reachable": ok}
                    else:
                        resp = {"error": f"unknown op {req.get('op')!r}"}
                    conn.sendall(_pack(self.key, resp))
                except Exception:
                    continue

    def close(self) -> None:
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass


def _can_connect(addr: str, port: int, timeout: float = 2.0) -> bool:
    try:
        with socket.create_connection((addr, port), timeout=timeout):
            return True
    except OSError:
        return False


def probe(host: str, port: int, key: str, request: dict, timeout: float = 10.0):
    """One signed request/response against a TaskServer.

    Both directions are a two-line frame (signature, payload) read with
    readline — never recv-to-EOF, since either side may hold makefile
    references that delay the FIN.
    """
    with socket.create_connection((host, port), timeout=timeout) as conn:
        conn.sendall(_pack(key, request))
        conn.shutdown(socket.SHUT_WR)
        with conn.makefile("rb") as f:
            raw = f.readline() + f.readline()
    return _unpack(key, raw)


def discover_common_interfaces(
    tasks: Sequence[Tuple[str, int]],
    key: str,
    *,
    probe_port: Optional[int] = None,
) -> List[str]:
    """Ring-probe NIC discovery (reference driver_service.py:128-197).

    ``tasks``: (host, task_server_port) per host, in rank order.  Each task
    ``i`` asks task ``i+1`` for its candidate addresses, then task ``i``
    connect-probes them (we drive both legs from the driver, like the
    reference's _run_probe fan-out).  Returns interface names reachable
    from every neighbor — the NICs safe for the coordinator/engine mesh.
    """
    n = len(tasks)
    if n == 0:
        return sorted(local_addresses())
    if n == 1:
        # Ask the (possibly remote) task server — answering from the
        # driver's own NICs would report the wrong host.
        host, port = tasks[0]
        addrs = probe(host, port, key, {"op": "addresses"})["addresses"]
        return sorted(addrs)
    common: Optional[set] = None
    for i in range(n):
        nxt = (i + 1) % n
        host_i, port_i = tasks[i]
        host_n, port_n = tasks[nxt]
        addrs = probe(host_n, port_n, key, {"op": "addresses"})["addresses"]
        candidates = [
            [iface, a, port_n] for iface, lst in addrs.items() for a in lst
        ]
        if probe_port is not None:
            candidates = [[i_, a, probe_port] for i_, a, _ in candidates]
        reach = probe(
            host_i, port_i, key, {"op": "probe", "candidates": candidates}
        )["reachable"]
        common = set(reach) if common is None else common & set(reach)
        if not common:
            break
    return sorted(common or [])


def _task_server_main() -> int:
    """Remote task-server entry (``python -m
    horovod_tpu_torch.run.driver_service``):
    serve until the launcher closes our stdin (≙ the ssh channel), the same
    lifetime coupling the reference's task services use."""
    import sys  # noqa: PLC0415

    key = os.environ.get("HVDTPU_NIC_SECRET")
    if not key:
        print("HVDTPU_NIC_SECRET not set", file=sys.stderr)
        return 2
    srv = TaskServer(key)
    print(f"HVDTPU_TASK_PORT={srv.port}", flush=True)
    try:
        sys.stdin.read()  # blocks until the launcher tears the channel down
    except KeyboardInterrupt:
        pass
    srv.close()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(_task_server_main())
