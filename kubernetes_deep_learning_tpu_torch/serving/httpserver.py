"""The threaded HTTP server both of the port's tiers listen with."""

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
