"""The card's peak allocated memory from process start to the window's
end, read before the reference runs, in GiB."""


def read(run):
    return run.peak / 2 ** 30
