"""The user limits of `morphik.mode="cloud"` against the JAX package's,
on the CPU.

- `models/tiers.py`: the tier table and the page estimate;
- `UserService`: the cases of `tests/test_limits.py` in both packages
  (enforced in cloud mode, a no-op self-hosted, `verify_only`, a tier
  upgrade), each limit up to its cap, the 30-day period reset, the apps
  quota counted once per app, and one `user_limits.db` counted by either
  package and read by the other; the guarded `UPDATE` holds the cap
  under concurrent threads;
- the servers in cloud mode: 402 on `/query`, `/ingest/text`, a file
  upload and app creation, equal `/usage/limits`, and one
  `user_limits.db` counted by the JAX server and read by the port's, and
  the reverse.
"""

import sqlite3
import sys
import threading
import time

import pytest

from conftest import run_once
from morphik_core_tpu.api.app import build_app as j_build_app
from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.models import tiers as jtiers
from morphik_core_tpu.services import user_service as jus
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models import tiers as ttiers
from morphik_core_tpu_torch.services import user_service as tus
from morphik_core_tpu_torch.services_init import build_services
from test_torch_service import _LoopThread, _call, _multipart, _raw_settings

PKGS = {"jax": jus, "torch": tus}


def test_tier_table_matches_jax():
    assert [t.value for t in ttiers.AccountTier] == [t.value for t in jtiers.AccountTier]
    assert {t.value: v for t, v in ttiers.TIER_LIMITS.items()} == {t.value: v for t, v in jtiers.TIER_LIMITS.items()}


@pytest.mark.parametrize("n_chars", [0, 10, 630 * 4, 630 * 4 + 1, 630 * 4 * 5, 999_999, 10**9])
def test_page_estimate_matches_jax(n_chars):
    assert ttiers.estimate_pages_from_chars(n_chars) == jtiers.estimate_pages_from_chars(n_chars)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_limits_enforced_in_cloud_mode(pkg):
    """`tests/test_limits.py::test_limits_enforced_in_cloud_mode` in each package."""
    mod = PKGS[pkg]

    async def go():
        svc = mod.UserService(":memory:", enforce=True)
        await svc.check_and_increment_limits("u1", "pages", 150)
        with pytest.raises(mod.LimitExceededError):
            await svc.check_and_increment_limits("u1", "pages", 100)  # free cap 200
        await svc.check_and_increment_limits("u1", "pages", 50, verify_only=True)
        await svc.check_and_increment_limits("u1", "pages", 50, verify_only=True)
        await svc.check_and_increment_limits("u1", "pages", 50)
        assert (await svc.get_user_limits("u1"))["usage"]["pages_used"] == 200
        await svc.set_tier("u1", "enterprise")
        await svc.check_and_increment_limits("u1", "pages", 10_000)

    run_once(go())


@pytest.mark.parametrize("pkg", list(PKGS))
def test_limits_noop_self_hosted(pkg):
    async def go():
        svc = PKGS[pkg].UserService(":memory:", enforce=False)
        await svc.check_and_increment_limits("u1", "queries", 10**9)
        await svc.check_and_increment_limits(None, "queries", 10**9)
        return await svc.get_user_limits("u1")

    assert run_once(go())["usage"]["queries_used"] == 0


def _sequence(mod, limit_type, steps, tier="free"):
    """Each step (amount, verify_only) -> "ok" or the error's text; then the user's limits."""

    async def go():
        svc = mod.UserService(":memory:", enforce=True)
        if tier != "free":
            await svc.set_tier("u", tier)
        out = []
        for amount, verify in steps:
            try:
                await svc.check_and_increment_limits("u", limit_type, amount, verify_only=verify)
                out.append("ok")
            except mod.LimitExceededError as e:
                out.append((e.limit_type, str(e)))
        return out, await svc.get_user_limits("u")

    return run_once(go())


@pytest.mark.parametrize("limit_type,tier,steps", [
    ("pages", "free", [(150.5, False), (49.5, True), (49.5, False), (0.5, False), (0.01, False)]),
    ("queries", "free", [(1, False)] * 3 + [(496, False), (1, True), (1, False), (1, True), (1, False)]),
    ("storage", "developer", [(10 * 1024**3 - 5, False), (5, True), (6, False), (5, False), (1, False)]),
    ("apps", "startup", [(19, False), (1, False), (1, False)]),
    ("queries", "enterprise", [(10**9, False), (10**9, False)]),
])
def test_limit_sequences_match_jax(limit_type, tier, steps):
    t = _sequence(tus, limit_type, steps, tier)
    j = _sequence(jus, limit_type, steps, tier)
    assert t == j
    assert any(x != "ok" for x in t[0]) == (tier != "enterprise")


def test_period_reset_matches_jax(tmp_path):
    """A period older than 30 days zeroes the monthly counters (not storage)."""
    out = {}
    for pkg, mod in PKGS.items():
        path = tmp_path / f"{pkg}.db"

        async def go():
            svc = mod.UserService(path, enforce=True)
            await svc.check_and_increment_limits("u", "queries", 7)
            await svc.check_and_increment_limits("u", "storage", 99)
            svc._conn.execute("UPDATE user_limits SET period_start=? WHERE user_id='u'", (time.time() - 31 * 86400,))
            svc._conn.commit()
            return await svc.get_user_limits("u")

        out[pkg] = run_once(go())
    assert out["torch"] == out["jax"]
    assert out["torch"]["usage"] == {"pages_used": 0, "queries_used": 0, "storage_bytes": 99, "apps_used": 0}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_apps_counted_once_per_app(pkg):
    mod = PKGS[pkg]

    async def go():
        svc = mod.UserService(":memory:", enforce=True)
        await svc.register_app("a1", "one", "u", "uri")
        await svc.register_app("a1", "one again", "u", "uri")  # a re-registration (a rotation)
        with pytest.raises(mod.LimitExceededError):
            await svc.register_app("a2", "two", "u", "uri")  # free: one app
        assert await svc.delete_app("a1", "u")
        await svc.register_app("a2", "two", "u", "uri")
        return (await svc.get_user_limits("u"))["usage"]["apps_used"], [a["app_id"] for a in await svc.list_apps("u")]

    assert run_once(go()) == (1, ["a2"])


@pytest.mark.parametrize("writer", list(PKGS))
def test_usage_db_shared(writer, tmp_path):
    """Usage counted by one package is read by the other, which counts on
    from there and hits the cap at the same request."""
    reader = "torch" if writer == "jax" else "jax"
    path = tmp_path / "user_limits.db"

    async def go():
        w = PKGS[writer].UserService(path, enforce=True)
        for _ in range(3):
            await w.check_and_increment_limits("u", "queries", 1)
        await w.check_and_increment_limits("u", "pages", 12.5)
        r = PKGS[reader].UserService(path, enforce=True)
        seen = await r.get_user_limits("u")
        await r.check_and_increment_limits("u", "queries", 496)
        with pytest.raises(PKGS[reader].LimitExceededError):
            await r.check_and_increment_limits("u", "queries", 2)
        await r.check_and_increment_limits("u", "queries", 1)
        with pytest.raises(PKGS[writer].LimitExceededError):
            await w.check_and_increment_limits("u", "queries", 1)
        return seen, await w.get_user_limits("u")

    seen, final = run_once(go())
    assert seen["usage"] == {"pages_used": 12.5, "queries_used": 3, "storage_bytes": 0, "apps_used": 0}
    assert final["usage"]["queries_used"] == 500


def test_guarded_update_holds_the_cap_under_threads(tmp_path):
    """16 threads each try 60 single queries against a cap of 500 (the
    advisory read passes for many of them at once): exactly 500 count."""
    svc = tus.UserService(tmp_path / "user_limits.db", enforce=True)
    counted, refused = [], []
    lock = threading.Lock()

    def worker():
        ok = bad = 0
        for _ in range(60):
            try:
                run_once(svc.check_and_increment_limits("u", "queries", 1))
                ok += 1
            except tus.LimitExceededError:
                bad += 1
        with lock:
            counted.append(ok)
            refused.append(bad)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sum(counted) == 500 and sum(refused) == 16 * 60 - 500
    assert run_once(svc.get_user_limits("u"))["usage"]["queries_used"] == 500


# ------------------------------------------------------------- the servers


def _cloud_settings(root, name):
    raw = _raw_settings(root, name)
    raw["morphik"] = {"enable_colpali": False, "mode": "cloud"}
    raw["parser"] = {"chunk_size": 400, "chunk_overlap": 40}
    return raw


def _start(lt, name, raw):
    if name == "torch":
        services = build_services(Settings.from_dict(raw), device="cpu")
        srv = HTTPServer(build_app(services), "127.0.0.1", 0)
    else:
        services = j_build_services(JSettings.model_validate(raw))
        srv = JHTTPServer(j_build_app(services), "127.0.0.1", 0)
    lt.run(services.initialize())
    lt.run(srv.start())
    return srv, services, f"http://127.0.0.1:{srv.port}"


@pytest.fixture(scope="module")
def cloud_servers(tmp_path_factory):
    """A port server and a JAX server in cloud mode, text path only."""
    root = tmp_path_factory.mktemp("cloud")
    lt = _LoopThread()
    out = {"root": root, "lt": lt, "base": {}, "services": {}}
    srvs = []
    try:
        for name in ("torch", "jax"):
            srv, services, base = _start(lt, name, _cloud_settings(root, name))
            srvs.append((srv, services))
            out["base"][name], out["services"][name] = base, services
        yield out
    finally:
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()


def _set_usage(cloud_servers, **cols):
    for name in ("torch", "jax"):
        path = cloud_servers["root"] / name / "storage" / "user_limits.db"
        with sqlite3.connect(path) as conn:
            conn.execute("INSERT OR IGNORE INTO user_limits (user_id, period_start) VALUES ('dev_user', ?)",
                         (time.time(),))
            for col, value in cols.items():
                conn.execute(f"UPDATE user_limits SET {col}=? WHERE user_id='dev_user'", (value,))


def _both(cloud_servers, method, path, body=None, headers=None):
    return [_call(cloud_servers["base"][n], method, path, body, headers) for n in ("torch", "jax")]


def test_cloud_query_402_matches_jax(cloud_servers):
    _set_usage(cloud_servers, queries_used=499)
    first = _both(cloud_servers, "POST", "/query", {"query": "anything", "k": 1, "use_colpali": False})
    second = _both(cloud_servers, "POST", "/query", {"query": "anything", "k": 1, "use_colpali": False})
    assert first[0][0] == first[1][0] == 200
    assert second[0] == second[1] and second[0][0] == 402, second
    assert "limit exceeded: queries" in second[0][1]["detail"]
    (ts_, tj), (js_, jj) = _both(cloud_servers, "GET", "/usage/limits")
    assert ts_ == js_ == 200 and tj == jj
    assert tj["usage"]["queries_used"] == 500 and tj["limits"]["queries_per_month"] == 500 and tj["tier"] == "free"


def test_cloud_ingest_text_402_matches_jax(cloud_servers):
    _set_usage(cloud_servers, pages_used=190.0)
    small = _both(cloud_servers, "POST", "/ingest/text", {"content": "a short note " * 20, "use_colpali": False})
    big = _both(cloud_servers, "POST", "/ingest/text", {"content": "word " * 40_000, "use_colpali": False})
    assert small[0][0] == small[1][0] == 200
    assert big[0] == big[1] and big[0][0] == 402, big
    (_, tj), (_, jj) = _both(cloud_servers, "GET", "/usage/limits")
    assert tj == jj and tj["usage"]["pages_used"] == 191.0


def test_cloud_file_upload_402_matches_jax(cloud_servers):
    """Storage counts the upload's bytes; pages are checked, not counted."""
    _set_usage(cloud_servers, storage_bytes=1024**3 - 100, pages_used=0.0)
    answers = []
    for size in (60, 60):
        body, ctype = _multipart("file", "n.txt", b"x" * size, "text/plain", {"use_colpali": "false"})
        answers.append(_both(cloud_servers, "POST", "/ingest/file", body, {"Content-Type": ctype}))
    assert answers[0][0][0] == answers[0][1][0] == 200
    assert answers[1][0] == answers[1][1] and answers[1][0][0] == 402, answers[1]
    (_, tj), (_, jj) = _both(cloud_servers, "GET", "/usage/limits")
    assert tj == jj and tj["usage"]["storage_bytes"] == 1024**3 - 40 and tj["usage"]["pages_used"] == 0.0


def test_cloud_app_creation_402_matches_jax(cloud_servers):
    first = _both(cloud_servers, "POST", "/cloud/generate_uri", {"name": "app1", "app_id": "app-1"})
    second = _both(cloud_servers, "POST", "/cloud/generate_uri", {"name": "app2", "app_id": "app-2"})
    assert first[0][0] == first[1][0] == 200
    assert second[0] == second[1] and second[0][0] == 402, second
    assert "limit exceeded: apps" in second[0][1]["detail"]


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_cloud_usage_shared_between_servers(tmp_path, first):
    """A JAX server and a port server on one storage path: the queries one
    counts, the other reports and counts on from."""
    second = "torch" if first == "jax" else "jax"
    raw = _cloud_settings(tmp_path, "shared")
    lt = _LoopThread()
    srvs = []
    try:
        bases = {}
        for name in (first, second):
            srv, services, bases[name] = _start(lt, name, raw)
            srvs.append((srv, services))
        for _ in range(3):
            assert _call(bases[first], "POST", "/query", {"query": "q", "k": 1, "use_colpali": False})[0] == 200
        status, limits = _call(bases[second], "GET", "/usage/limits")
        assert status == 200 and limits["usage"]["queries_used"] == 3
        assert _call(bases[second], "POST", "/query", {"query": "q", "k": 1, "use_colpali": False})[0] == 200
        assert _call(bases[first], "GET", "/usage/limits")[1]["usage"]["queries_used"] == 4
    finally:
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()
