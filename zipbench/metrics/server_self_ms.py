"""Host time per step of the serving loop outside its call into the model
(``BatchServer``'s admission, page pool, sampling and bookkeeping): each
window step's wall time since the previous step ended, minus the harness's
span around ``ZipServer.decode_rows``; mean over the window's steps, ms."""


def read(v):
    if len(v.steps) < 2:
        return None
    steps = v.steps[1:]        # the first step's wall reaches before the window
    return sum(s.server_s for s in steps) / len(steps) * 1e3
