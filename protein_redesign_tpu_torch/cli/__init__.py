"""Command-line entry points of the port."""

import functools


def command(run):
    """A CLI's ``main``: ``main(argv)`` gives an in-process caller what
    ``run(argv)`` returns (a runner, timings, a train state); ``main()``
    without ``argv``, as ``python -m`` and the ``prd-torch-*`` console
    scripts call it, returns None, since a console script exits with
    ``main()``'s value and would exit 1 on an object."""

    @functools.wraps(run)
    def main(argv=None):
        result = run(argv)
        return None if argv is None else result

    return main
