"""The renderer's KNN base scale: the port's "knn" span, ms per step."""


def read(t):
    return t.span_ms("knn")
