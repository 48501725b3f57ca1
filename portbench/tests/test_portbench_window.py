"""The window rule: it closes at the end of the first request that ends
past ``--seconds``, and counts every request it ran."""

from pbcore import window


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_window_closes_after_first_request_past_seconds():
    clock = Clock()
    done = []

    def request(k):
        clock.now += 3.0   # each request takes 3 s
        done.append(k)

    n, elapsed = window.closed_loop(request, 10.0, clock=clock)
    # ends at 3, 6, 9 (< 10), then 12: the fourth request closes the window
    assert (n, elapsed, done) == (4, 12.0, [0, 1, 2, 3])


def test_window_of_one_long_request():
    clock = Clock()

    def request(k):
        clock.now += 30.0

    assert window.closed_loop(request, 10.0, clock=clock) == (1, 30.0)


def test_processes_follow_process_zero():
    clock = Clock()
    asked = []

    def request(k):
        clock.now += 1.0

    def agree(go_on):   # process 0 stops after two requests
        asked.append(go_on)
        return len(asked) < 2

    assert window.closed_loop(request, 100.0, agree=agree, clock=clock) == (2, 2.0)
