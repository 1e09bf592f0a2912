"""Named datasource drivers (reference ``sentinel-datasource-*`` modules).

PUSH drivers (rule change visible without waiting out a poll interval —
the reference's listener/watch semantics):

- :class:`ConsulDataSource` — KV blocking queries (``X-Consul-Index``),
  like ``sentinel-datasource-consul``'s long-poll watch.
- :class:`NacosDataSource` — the Nacos config LISTENER long-poll protocol
  (``/v1/cs/configs/listener`` with MD5 bookkeeping, 30 s hold), like
  ``sentinel-datasource-nacos``'s ``ConfigService.addListener``; degrades
  to conditional-GET polling when the listener endpoint is unavailable.
- :class:`EtcdDataSource` — v3 gRPC-gateway ``/v3/watch`` streaming watch
  with ``/v3/kv/range`` for the initial read and as the poll fallback,
  like ``sentinel-datasource-etcd``'s ``Watch.watch``.
- :class:`ZooKeeperDataSource` — node data watch (kazoo ``DataWatch``,
  client injectable for tests), like ``sentinel-datasource-zookeeper``'s
  Curator ``NodeCache`` listener.
- :class:`RedisDataSource` — initial GET + pub/sub channel updates,
  like ``sentinel-datasource-redis``; requires the ``redis`` package
  (gated import — this build image doesn't ship it).

Pull drivers (each system only offers a fetch API):

- :class:`EurekaDataSource` / :class:`SpringCloudConfigDataSource` /
  :class:`ApolloDataSource` — plain conditional-GET polls over each
  system's config URL shape.

The PyTorch port's own copy of ``sentinel_tpu/datasource/named.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from sentinel_tpu_torch.core.logs import record_log
from sentinel_tpu_torch.datasource.base import (
    AutoRefreshDataSource, Converter, T,
)
from sentinel_tpu_torch.datasource.http import (
    HttpLongPollDataSource, HttpRefreshableDataSource,
)

# Nacos listener framing (reference NacosDataSource / Nacos open API)
_NACOS_WORD_SEP = "\x02"
_NACOS_LINE_SEP = "\x01"


class ConsulDataSource(HttpLongPollDataSource[T]):
    def __init__(self, host: str, port: int, rule_key: str,
                 converter: Converter, *, token: Optional[str] = None,
                 wait: str = "25s", **kw):
        headers = dict(kw.pop("headers", {}) or {})
        if token:
            headers["X-Consul-Token"] = token
        super().__init__(
            f"http://{host}:{port}/v1/kv/{rule_key}?raw",
            converter, index_header="X-Consul-Index", wait=wait,
            headers=headers, **kw)


class NacosDataSource(HttpRefreshableDataSource[T]):
    """Nacos config listener (PUSH): each refresh cycle issues the open-API
    long-poll — POST ``/v1/cs/configs/listener`` with
    ``dataId^2group^2md5[^2tenant]^1`` and a ``Long-Pulling-Timeout``
    header — which the server holds until the config's MD5 changes (or the
    hold expires). A change answers immediately → the config is fetched at
    once, so updates land in ~RTT instead of a poll interval. If the
    listener endpoint is unavailable the driver degrades to plain
    conditional-GET polling every ``refresh_ms``."""

    def __init__(self, server_addr: str, data_id: str, group: str,
                 converter: Converter, *, namespace: str = "",
                 refresh_ms: int = 3000, listen_timeout_ms: int = 30_000,
                 **kw):
        self.data_id = data_id
        self.group = group
        self.namespace = namespace
        self.listen_timeout_ms = listen_timeout_ms
        self._listener_url = f"http://{server_addr}/nacos/v1/cs/configs/listener"
        self._md5 = ""
        # monotonic deadline before which the listener is not attempted —
        # a failed long-poll falls back to polling for one cooldown, then
        # re-probes (the reference listener keeps retrying; a permanent
        # downgrade would silently lose push semantics forever)
        self._listener_retry_at = 0.0
        self.listener_cooldown_s = 30.0
        qs = f"dataId={urllib.parse.quote(data_id)}" \
             f"&group={urllib.parse.quote(group)}"
        if namespace:
            qs += f"&tenant={urllib.parse.quote(namespace)}"
        super().__init__(f"http://{server_addr}/nacos/v1/cs/configs?{qs}",
                         converter, refresh_ms, **kw)

    def read_source(self) -> str:
        body = super().read_source()
        self._md5 = hashlib.md5(body.encode("utf-8")).hexdigest() if body \
            else ""
        return body

    def _listen_once(self) -> bool:
        """One listener long-poll → True when the server reports a change
        (caller re-reads the config)."""
        fields = [self.data_id, self.group, self._md5]
        if self.namespace:
            fields.append(self.namespace)
        listening = _NACOS_WORD_SEP.join(fields) + _NACOS_LINE_SEP
        data = urllib.parse.urlencode(
            {"Listening-Configs": listening}).encode()
        req = urllib.request.Request(
            self._listener_url, data=data,
            headers={**self.headers,
                     "Long-Pulling-Timeout": str(self.listen_timeout_ms),
                     "Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(
                req, timeout=self.listen_timeout_ms / 1000.0 + 10) as r:
            return bool(r.read().decode("utf-8").strip())

    def _listener_active(self) -> bool:
        import time as _time

        return _time.monotonic() >= self._listener_retry_at

    def refresh_now(self) -> bool:
        if not self._listener_active():
            return super().refresh_now()     # poll fallback (cooldown)
        try:
            changed = self._listen_once()
        except Exception as exc:
            # broad on purpose (base-class refresh contract): ANY listener
            # failure — IncompleteRead, protocol error, refused — must not
            # kill the refresh thread; poll for a cooldown, then re-probe
            import time as _time

            record_log().warning(
                "nacos listener unavailable (%r); polling for %.0fs",
                exc, self.listener_cooldown_s)
            self._listener_retry_at = (_time.monotonic()
                                       + self.listener_cooldown_s)
            return super().refresh_now()
        if self._stop.is_set() or not changed:
            return False
        return super().refresh_now()

    def _loop(self) -> None:
        # push mode paces itself by the server-held long-poll; the poll
        # fallback keeps the configured interval
        while not self._stop.wait(
                0.05 if self._listener_active()
                else self.refresh_ms / 1000.0):
            self.refresh_now()


class EtcdDataSource(HttpRefreshableDataSource[T]):
    """etcd v3 over the gRPC-gateway (PUSH): initial read + poll fallback
    via POST ``/v3/kv/range`` (base64 key, value base64-decoded before
    conversion), plus a WATCH stream — POST ``/v3/watch`` with a
    ``create_request``, the gateway streaming one JSON object per change —
    so updates land in ~RTT like the reference driver's ``Watch.watch``.
    The watch thread reconnects after errors; the poll loop remains as the
    safety net (its interval only matters while the watch is down)."""

    def __init__(self, host: str, port: int, key: str,
                 converter: Converter, *, refresh_ms: int = 3000,
                 watch: bool = True, watch_reconnect_s: float = 2.0,
                 watch_idle_timeout_s: float = 120.0, **kw):
        self._range_key = base64.b64encode(key.encode()).decode()
        self._watch_url = f"http://{host}:{port}/v3/watch"
        self._watch_reconnect_s = watch_reconnect_s
        self._watch_idle_timeout_s = watch_idle_timeout_s
        super().__init__(f"http://{host}:{port}/v3/kv/range",
                         converter, refresh_ms, **kw)
        self._watch_thread: Optional[threading.Thread] = None
        if watch:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="sentinel-etcd-watch")
            self._watch_thread.start()

    def _request(self) -> urllib.request.Request:
        body = json.dumps({"key": self._range_key}).encode()
        return urllib.request.Request(
            self.url, data=body,
            headers={**self.headers, "Content-Type": "application/json"})

    def read_source(self) -> str:
        with urllib.request.urlopen(self._request(),
                                    timeout=self.timeout_s) as r:
            payload = json.loads(r.read().decode("utf-8"))
        kvs = payload.get("kvs") or []
        body = (base64.b64decode(kvs[0]["value"]).decode("utf-8")
                if kvs else "")
        self._last_body = body
        return body

    def _watch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                body = json.dumps(
                    {"create_request": {"key": self._range_key}}).encode()
                req = urllib.request.Request(
                    self._watch_url, data=body,
                    headers={**self.headers,
                             "Content-Type": "application/json"})
                # idle read timeout: an LB/NAT can drop the long-lived
                # stream without FIN, which would otherwise block this
                # thread forever with the reconnect path unreachable;
                # timing out a healthy-but-quiet stream just re-creates
                # the watch, which is harmless
                with urllib.request.urlopen(
                        req, timeout=self._watch_idle_timeout_s) as r:
                    for line in r:               # one JSON object per change
                        if self._stop.is_set():
                            return
                        self._on_watch_line(line)
            except Exception as exc:
                # broad on purpose: a malformed document (converter
                # KeyError), IncompleteRead, or protocol error must
                # reconnect the watch, not kill the thread forever
                if self._stop.is_set():
                    return
                record_log().warning("etcd watch dropped (%r); retrying",
                                     exc)
            self._stop.wait(self._watch_reconnect_s)

    def _on_watch_line(self, line: bytes) -> None:
        line = line.strip()
        if not line:
            return
        doc = json.loads(line.decode("utf-8"))
        events = (doc.get("result") or {}).get("events") or []
        for evt in events:
            kv = evt.get("kv") or {}
            raw = kv.get("value")
            body = (base64.b64decode(raw).decode("utf-8")
                    if raw else "")
            if body != self._last_body:
                self._last_body = body
                self.property.update_value(self.converter(body))

    def close(self) -> None:
        super().close()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=1.0)
            self._watch_thread = None


class EurekaDataSource(HttpRefreshableDataSource[T]):
    """Config served by an app registered in Eureka — the reference driver
    resolves an instance and GETs its rule endpoint; here the resolved URL
    is given directly (service discovery stays the caller's concern)."""

    def __init__(self, rule_url: str, converter: Converter, **kw):
        super().__init__(rule_url, converter, **kw)


class SpringCloudConfigDataSource(HttpRefreshableDataSource[T]):
    def __init__(self, server_addr: str, application: str, profile: str,
                 label: str, key: str, converter: Converter, **kw):
        self._key = key
        super().__init__(
            f"http://{server_addr}/{application}/{profile}/{label}",
            converter, **kw)

    def read_source(self) -> str:
        # _last_body stays the RAW envelope (the base class's 304 path
        # replays it through this extraction again)
        raw = super().read_source()
        try:
            doc = json.loads(raw)
            for ps in doc.get("propertySources", []):
                src = ps.get("source", {})
                if self._key in src:
                    return str(src[self._key])
        except (ValueError, AttributeError):
            pass
        return ""


class ApolloDataSource(HttpRefreshableDataSource[T]):
    def __init__(self, server_addr: str, app_id: str, cluster: str,
                 namespace: str, key: str, converter: Converter, **kw):
        self._key = key
        super().__init__(
            f"http://{server_addr}/configs/{app_id}/{cluster}/{namespace}",
            converter, **kw)

    def read_source(self) -> str:
        raw = super().read_source()    # _last_body stays the raw envelope
        try:
            return str(json.loads(raw).get("configurations", {})
                       .get(self._key, ""))
        except (ValueError, AttributeError):
            return ""


class ZooKeeperDataSource:
    """ZooKeeper node watch (reference ``sentinel-datasource-zookeeper``:
    Curator ``NodeCache`` + listener → here a kazoo ``DataWatch``).

    ``client`` injects any kazoo-compatible object (``start()``,
    ``DataWatch(path, fn)`` where ``fn(data, stat)`` fires on every change,
    ``stop()``/``close()``) — tests drive a fake; production passes a real
    ``kazoo.client.KazooClient`` or lets the gated import construct one."""

    def __init__(self, hosts: str, path: str, converter: Converter, *,
                 client=None):
        from sentinel_tpu_torch.core.property import SentinelProperty

        if client is None:
            try:
                from kazoo.client import KazooClient
            except ImportError as exc:
                raise ImportError(
                    "ZooKeeperDataSource requires the 'kazoo' package (or "
                    "pass a kazoo-compatible client=); install it or use a "
                    "file/HTTP datasource") from exc
            client = KazooClient(hosts=hosts)
        self.converter = converter
        self.property = SentinelProperty()
        self._client = client
        self._client.start()
        # DataWatch fires immediately with the current value, then on every
        # change — the NodeCache initial-load + listener semantics
        self._client.DataWatch(path, self._on_change)

    def _on_change(self, data, stat, *_) -> None:
        body = data.decode("utf-8") if isinstance(data, bytes) else (data or "")
        try:
            self.property.update_value(self.converter(body))
        except Exception as exc:
            record_log().warning("zookeeper datasource convert failed: %r",
                                 exc)

    def get_property(self):
        return self.property

    def close(self) -> None:
        try:
            self._client.stop()
        finally:
            close = getattr(self._client, "close", None)
            if close is not None:
                close()


class RedisDataSource:
    """Initial GET + pub/sub update channel (``sentinel-datasource-redis``).
    Requires the ``redis`` package; constructing without it raises with a
    clear message (the build image doesn't bundle redis)."""

    def __init__(self, host: str, port: int, rule_key: str, channel: str,
                 converter: Converter, *, db: int = 0,
                 password: Optional[str] = None):
        try:
            import redis
        except ImportError as exc:
            raise ImportError(
                "RedisDataSource requires the 'redis' package; install it "
                "or use a file/HTTP datasource") from exc
        from sentinel_tpu_torch.core.property import SentinelProperty

        self.converter = converter
        self.property = SentinelProperty()
        self._client = redis.Redis(host=host, port=port, db=db,
                                   password=password)
        initial = self._client.get(rule_key)
        if initial is not None:
            self.property.update_value(converter(initial.decode("utf-8")))
        self._pubsub = self._client.pubsub()
        self._pubsub.subscribe(**{channel: self._on_message})
        self._thread = self._pubsub.run_in_thread(sleep_time=0.1,
                                                  daemon=True)

    def _on_message(self, message) -> None:
        if message.get("type") == "message":
            data = message["data"]
            if isinstance(data, bytes):
                data = data.decode("utf-8")
            self.property.update_value(self.converter(data))

    def get_property(self):
        return self.property

    def close(self) -> None:
        self._thread.stop()
        self._pubsub.close()
        self._client.close()
