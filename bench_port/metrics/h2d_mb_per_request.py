"""The window's mean of the program's own ``timings["h2d_bytes"]``: the
bytes of every host array the program put on the stitch's device (the
images, the projection maps, the fold's overlap ranges, the padding
indices; counted at each site), over the completed requests, in 10^6
bytes per request.  Nothing to read where the program has no such
counter."""


def read(run):
    done = [r.timings["h2d_bytes"] for r in run.window.records
            if r.ok and r.timings is not None and "h2d_bytes" in r.timings]
    return sum(done) / len(done) / 1e6 if done else None
