"""Output tokens the host received in the window, first tokens
included, over the window's seconds: every token of each request
completed inside it (the window runs from one batch's completion to
another's, so each of its requests was admitted and answered in it)."""


def read(run):
    return sum(run.own.tokens[t.key] for t in run.done()) / run.seconds
