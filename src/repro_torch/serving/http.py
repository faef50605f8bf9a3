"""Minimal HTTP/1.1 plumbing of the frontend (port of ``repro/serving/http.py``).

The serving processes speak one deliberately small dialect — one request
per connection, ``Connection: close``, JSON bodies, chunked NDJSON for
progress streams — implemented here over raw asyncio streams with no
third-party dependency.  :mod:`repro_torch.serving.frontend` (the
per-replica server) builds on these helpers; they sit in their own module,
free of torch, so a replica gateway can import them without the engine.
"""
from __future__ import annotations

import asyncio
import json
from http import HTTPStatus

#: request bodies are tiny JSON; anything bigger is a client bug
MAX_BODY = 1 << 20

#: response header every v1-compat-shim response carries (RFC 9745 shape)
DEPRECATION_HEADER = (b"Deprecation", b'version="v1"')


async def read_http_request(reader: asyncio.StreamReader) -> tuple[str, str, dict, bytes]:
    """Parse one request: (method, path, lowercase headers, body)."""
    line = await reader.readline()
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        raise ValueError(f"malformed request line: {line!r}")
    method, path = parts[0].upper(), parts[1]
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", 0))
    if n > MAX_BODY:
        raise ValueError(f"body too large ({n} bytes)")
    body = await reader.readexactly(n) if n > 0 else b""
    return method, path, headers, body


def status_line(status: int) -> bytes:
    phrase = HTTPStatus(status).phrase
    return f"HTTP/1.1 {status} {phrase}\r\n".encode()


def extra_header_bytes(extra_headers: tuple[tuple[bytes, bytes], ...]) -> bytes:
    return b"".join(k + b": " + v + b"\r\n" for k, v in extra_headers)


async def send_json(
    writer: asyncio.StreamWriter, status: int, payload: dict,
    extra_headers: tuple[tuple[bytes, bytes], ...] = (),
) -> None:
    body = (json.dumps(payload) + "\n").encode()
    writer.write(
        status_line(status)
        + b"Content-Type: application/json\r\n"
        + f"Content-Length: {len(body)}\r\n".encode()
        + extra_header_bytes(extra_headers)
        + b"Connection: close\r\n\r\n"
        + body
    )
    await writer.drain()


async def start_chunked(
    writer: asyncio.StreamWriter, status: int = 200,
    extra_headers: tuple[tuple[bytes, bytes], ...] = (),
) -> None:
    writer.write(
        status_line(status)
        + b"Content-Type: application/x-ndjson\r\n"
        + b"Transfer-Encoding: chunked\r\n"
        + extra_header_bytes(extra_headers)
        + b"Connection: close\r\n\r\n"
    )
    await writer.drain()


def chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"
