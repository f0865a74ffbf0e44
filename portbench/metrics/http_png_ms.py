"""What HTTP and PNG add to a request: its time as the viewer saw it less
the time of the service's render (the harness's own instance, timed to the
end of its device work), averaged over the untraced block's requests, ms."""


def read(prof):
    return prof.extra.get("http_png_ms")
