"""Server entry of the port: `python -m morphik_core_tpu_torch.api.server
[config.toml]` boots the services on the card, the job workers and the
HTTP server (`morphik_core_tpu/api/server.py:19-50` for the port).
Without a card it exits with the `RuntimeError` of
`device.default_device()`: the server never runs on the CPU.

The service modules are imported inside `main`: the PDF raster pool's
forkserver children import this module again as their `__main__`, and
they must load numpy modules only (no torch)."""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

logger = logging.getLogger(__name__)


async def main(config_path: str | None = None) -> None:
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import get_settings
    from morphik_core_tpu_torch.services_init import build_services

    settings = get_settings(config_path)
    services = build_services(settings)
    await services.initialize()
    server = HTTPServer(build_app(services), settings.api.host, settings.api.port)

    # graceful drain on SIGTERM/SIGINT: stop accepting, let the running
    # ingest job finish (queued jobs persist in sqlite), then shut down
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix
            pass
    await server.start()
    logger.info("morphik-core-tpu (torch) serving on %s:%d", settings.api.host, server.port)
    try:
        await stop.wait()
        logger.info("shutdown signal received; draining")
    finally:
        await server.stop()
        await services.shutdown()
        logger.info("shutdown complete")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    asyncio.run(main(sys.argv[1] if len(sys.argv) > 1 else None))
