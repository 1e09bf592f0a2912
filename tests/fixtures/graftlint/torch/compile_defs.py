"""Defining side of the cross-module TRACE001 pair: ``body_fn`` looks
like a plain function here — the ``torch.compile`` wrap lives in
compile_site.py."""


def body_fn(x):
    return x.sum().item()                     # TRACE001 via cross-module wrap


def never_compiled(x):
    return x.sum().item()                     # no wrap site anywhere: clean
