"""A hard time limit for one test: past ``seconds``, SIGALRM raises
`TimeoutError` in the test, so a hang fails it instead of running into the
suite's clock.  Only the main thread can take signals; elsewhere there is
no limit."""

import contextlib
import signal
import threading


@contextlib.contextmanager
def time_limit(seconds: float):
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(*_):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
