"""Asynchronous leveled logger.

Log records are formatted on the calling thread and queued to a dedicated
writer thread, so the hot pipeline never blocks on IO; fatal signals flush
the queue before re-raising.  Parity: reference include/pacbio/ccs/
Logging.h:58-368 (8 levels, UTC timestamps + thread ids, async queue,
signal-handler flush).

Copy of pbccs_tpu.runtime.logging.
"""

from __future__ import annotations

import atexit
import datetime
import enum
import queue
import signal
import sys
import threading
import traceback
from typing import TextIO


class LogLevel(enum.IntEnum):
    TRACE = 0
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    CRITICAL = 6
    FATAL = 7

    @staticmethod
    def from_string(name: str) -> "LogLevel":
        try:
            return LogLevel[name.upper()]
        except KeyError:
            raise ValueError(f"invalid log level: {name!r}") from None


class Logger:
    """Async logger with a dedicated writer thread."""

    _default: "Logger | None" = None
    _default_lock = threading.Lock()
    _atexit_installed = False

    def __init__(self, stream: TextIO | None = None,
                 level: LogLevel = LogLevel.INFO):
        self._stream = stream if stream is not None else sys.stderr
        self.level = level
        self._queue: queue.Queue[str | None] = queue.Queue()
        self._thread = threading.Thread(target=self._writer, daemon=True,
                                        name="pbccs-log-writer")
        self._thread.start()

    # ------------------------------------------------------------- plumbing

    def _writer(self) -> None:
        while True:
            msg = self._queue.get()
            try:
                if msg is None:
                    return
                self._stream.write(msg)
                self._stream.flush()
            except Exception:  # noqa: BLE001 -- logging must never raise
                pass
            finally:
                self._queue.task_done()

    def log(self, level: LogLevel, message: str) -> None:
        if level < self.level:
            return
        now = datetime.datetime.now(datetime.timezone.utc)
        tid = threading.get_ident() & 0xFFFF
        self._queue.put(
            f">|> {now:%Y%m%d %H:%M:%S.%f} -|- {level.name} -|- "
            f"0x{tid:04x} -|- {message}\n")

    def flush(self) -> None:
        """Block until every queued record has been written."""
        self._queue.join()

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------ interface

    def trace(self, msg: str) -> None: self.log(LogLevel.TRACE, msg)
    def debug(self, msg: str) -> None: self.log(LogLevel.DEBUG, msg)
    def info(self, msg: str) -> None: self.log(LogLevel.INFO, msg)
    def notice(self, msg: str) -> None: self.log(LogLevel.NOTICE, msg)
    def warn(self, msg: str) -> None: self.log(LogLevel.WARN, msg)
    def error(self, msg: str) -> None: self.log(LogLevel.ERROR, msg)
    def critical(self, msg: str) -> None: self.log(LogLevel.CRITICAL, msg)
    def fatal(self, msg: str) -> None: self.log(LogLevel.FATAL, msg)

    # ------------------------------------------------------------- default

    @classmethod
    def default(cls, logger: "Logger | None" = None) -> "Logger":
        """Get (or install) the process-default logger.

        Locked: two threads racing the first call used to construct TWO
        loggers -- two writer threads, interleaved half-installed state --
        and the loser's writer thread leaked for the process lifetime."""
        with cls._default_lock:
            if logger is not None:
                cls._default = logger
            if cls._default is None:
                cls._default = Logger()
            if not cls._atexit_installed:
                cls._atexit_installed = True
                atexit.register(cls._flush_default_at_exit)
            return cls._default

    @classmethod
    def _flush_default_at_exit(cls) -> None:
        """Drain + stop the default logger's writer thread at interpreter
        exit so queued records (e.g. from a CLI run) are never dropped."""
        with cls._default_lock:
            log = cls._default
        if log is not None:
            try:
                log.flush()
                log.close()
            except Exception:  # noqa: BLE001 -- logging must never raise
                pass


def install_signal_handlers(logger: Logger | None = None) -> None:
    """Flush the async logger on fatal signals, then re-raise the default
    behavior (reference Logging.h:328-364)."""
    logger = logger or Logger.default()

    def handler(signum, frame):
        logger.fatal(f"caught signal {signal.Signals(signum).name}:\n"
                     + "".join(traceback.format_stack(frame)))
        logger.flush()
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)

    for sig in (signal.SIGABRT, signal.SIGINT, signal.SIGSEGV, signal.SIGTERM):
        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
