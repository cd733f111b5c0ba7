from textgcn.inspect.topics import inspect_topics  # noqa: F401
