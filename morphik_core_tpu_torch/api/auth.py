"""Auth: JWT (HS256, stdlib hmac) bearer verification + dev bypass. Copy
of `morphik_core_tpu/api/auth.py`.

Mirrors reference core/auth_utils.py:90-205: bearer JWT with
entity_type/entity_id/app_id/permissions claims, expiry check, and a
dev mode that injects a developer AuthContext when bypass_auth_mode is
on. Cloud URI scheme morphik://<owner_id>:<token>@<host> is generated by
/local/generate_uri (reference api.py:963)."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional

from morphik_core_tpu_torch.api.http import HTTPError, Request
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.schemas import AuthContext, EntityType


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(payload: Dict[str, Any], secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(payload, default=str).encode())
    signing_input = f"{header}.{body}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url(sig)}"


def jwt_decode(token: str, secret: str) -> Dict[str, Any]:
    try:
        header, body, sig = token.split(".")
        signing_input = f"{header}.{body}".encode()
        expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_dec(sig)):
            raise HTTPError(401, "invalid token signature")
        payload = json.loads(_b64url_dec(body))
    except HTTPError:
        raise
    except Exception as e:  # noqa: BLE001 — bad base64/json/etc
        raise HTTPError(401, "malformed token") from e
    exp = payload.get("exp")
    if exp is not None and float(exp) < time.time():
        raise HTTPError(401, "token expired")
    return payload


def create_token(
    settings: Settings,
    entity_id: str,
    entity_type: str = "developer",
    app_id: Optional[str] = None,
    permissions: Optional[list] = None,
    expires_in_s: int = 30 * 24 * 3600,
    user_id: Optional[str] = None,
    token_version: Optional[int] = None,
) -> str:
    payload = {
        "type": entity_type,
        "entity_id": entity_id,
        # least privilege by default: admin must be requested EXPLICITLY
        # (an admin-by-default mint made the cross-user guards on /apps
        # and /logs vacuous for every provisioned token)
        "permissions": permissions or ["read", "write"],
        "exp": time.time() + expires_in_s,
    }
    if app_id:
        payload["app_id"] = app_id
    if user_id:
        payload["user_id"] = user_id
    if token_version is not None:
        payload["token_version"] = token_version
    return jwt_encode(payload, settings.auth.jwt_secret_key)


def verify_token(request: Request, settings: Settings) -> AuthContext:
    auth_header = request.headers.get("authorization", "")
    if settings.auth.bypass_auth_mode and not auth_header:
        return AuthContext(
            entity_type=EntityType.DEVELOPER,
            entity_id=settings.auth.dev_user_id,
            permissions=set(settings.auth.dev_permissions),
            user_id=settings.auth.dev_user_id,
        )
    if not auth_header.lower().startswith("bearer "):
        raise HTTPError(401, "missing bearer token")
    payload = jwt_decode(auth_header[7:], settings.auth.jwt_secret_key)
    return AuthContext(
        entity_type=EntityType(payload.get("type", "developer")),
        entity_id=payload.get("entity_id", ""),
        app_id=payload.get("app_id"),
        permissions=set(payload.get("permissions", ["read"])),
        user_id=payload.get("user_id", payload.get("entity_id")),
        token_version=payload.get("token_version"),
    )
