"""Simple session auth (reference ``sentinel-dashboard/.../auth/``:
``SimpleWebAuthServiceImpl`` + ``LoginAuthenticationFilter`` — a single
configured user, session-cookie based, with ``/registry/machine`` and login
endpoints exempt).

Credentials default to ``sentinel``/``sentinel`` like the reference
(``auth.username``/``auth.password`` properties); empty password disables
auth entirely (the reference's ``NoOpAuthServiceImpl`` profile).

The PyTorch port's own copy of ``sentinel_tpu/dashboard/auth.py``.
"""

from __future__ import annotations

import secrets
import threading
import time
from typing import Dict, Optional

SESSION_TTL_S = 2 * 3600

EXEMPT_PREFIXES = ("/registry/machine", "/auth/login", "/auth/check",
                   "/static/", "/favicon.ico")


class AuthService:
    def __init__(self, username: str = "sentinel",
                 password: str = "sentinel"):
        self.username = username
        self.password = password
        self._lock = threading.Lock()
        self._sessions: Dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.password)

    def login(self, username: str, password: str) -> Optional[str]:
        if username != self.username or password != self.password:
            return None
        token = secrets.token_urlsafe(24)
        with self._lock:
            self._sessions[token] = time.time() + SESSION_TTL_S
        return token

    def logout(self, token: str) -> None:
        with self._lock:
            self._sessions.pop(token, None)

    def check(self, token: Optional[str]) -> bool:
        if not self.enabled:
            return True
        if not token:
            return False
        with self._lock:
            exp = self._sessions.get(token)
            if exp is None:
                return False
            if exp < time.time():
                del self._sessions[token]
                return False
            return True

    def exempt(self, path: str) -> bool:
        return path == "/" or path.endswith(".html") or any(
            path.startswith(p) for p in EXEMPT_PREFIXES)
