"""The threaded HTTP server both of the port's tiers listen with, and the
chunked reply both write a token stream with."""

from __future__ import annotations

from http.server import ThreadingHTTPServer

# socketserver listens with a backlog of 5.  A burst of new connections (a
# gateway filling its upstream pool, clients arriving together, a fetch per
# request) overflows it, and every dropped SYN costs its client a 1 s (then
# 3 s) retransmit: a tail of whole seconds that no stage of the request
# shows.  The kernel caps the backlog at net.core.somaxconn.
LISTEN_BACKLOG = 1024


class ServingHTTPServer(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG
    daemon_threads = True


def send_chunked(handler, status: int, chunks, ctype: str, headers: dict[str, str]) -> None:
    """Write an iterator of byte chunks as one HTTP/1.1 chunked reply on a
    ``BaseHTTPRequestHandler`` (the SSE token path), each chunk as it comes.
    A client that went away ends the write and retires the connection; the
    iterator is closed either way, so a generation still running is
    cancelled (its generator's finally runs)."""
    try:
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Transfer-Encoding", "chunked")
        for key, value in headers.items():
            handler.send_header(key, value)
        handler.end_headers()
        for chunk in chunks:
            if chunk:
                handler.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
        handler.wfile.write(b"0\r\n\r\n")
    except OSError:
        handler.close_connection = True
    finally:
        chunks.close()
