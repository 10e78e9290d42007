"""Device-memory evictions per tile: the rise of
``WorkerRuntime.stats()["device_evictions"]`` over the window, divided
by the tiles completed in it."""


def read(run):
    done = len(run.done())
    return run.counter_delta("device_evictions") / done if done else None
