"""Prompt tokens whose first output token reached the host inside the
window, over the window's seconds (first dispatch to last first token)."""


def read(run):
    return sum(r["prompt_tokens"] for r in run["records"]) / run["window_s"]
