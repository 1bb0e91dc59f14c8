"""The renderer's KNN base scale: the port's "knn" span, ms per request."""


def read(t):
    return t.span_ms("knn")
