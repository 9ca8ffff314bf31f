"""Telnet remote-control server (reference src/telnetserver.cpp; port of
qradiolink_tpu/app/telnet.py, host-side).

A line-oriented TCP server on the reference's control port 4939
(src/config_defines.h:16) feeding CommandProcessor. Each connection
gets the welcome banner; "exit"/"quit" closes the session; the
"shutdown" verb stops the whole server (reference behavior: qApp
quit). Threaded so the radio loop keeps running while sessions are
open.
"""

from __future__ import annotations

import socket
import socketserver
import threading

CONTROL_PORT = 4939
WELCOME = (b"Welcome! qradiolink-tpu headless control\r\n"
           b"Type help or ? to list commands\r\n")


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        self.wfile.write(WELCOME)
        proc = self.server.processor
        while True:
            try:
                raw = self.rfile.readline()
            except (ConnectionError, OSError):
                break
            if not raw:
                break
            line = raw.decode("utf-8", "replace").strip()
            if line.lower() in ("exit", "quit"):
                self.wfile.write(b"Bye\r\n")
                break
            resp = proc.process(line)
            if resp:
                self.wfile.write(resp.encode() + b"\r\n")
            if proc.shutdown_requested:
                self.server.stop_flag.set()
                break


class TelnetServer:
    def __init__(self, processor, host: str = "127.0.0.1",
                 port: int = CONTROL_PORT):
        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self.server = Srv((host, port), _Handler)
        self.server.processor = processor
        self.server.stop_flag = threading.Event()
        self.port = self.server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self.server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()

    @property
    def shutdown_requested(self) -> bool:
        return self.server.stop_flag.is_set()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=2)
