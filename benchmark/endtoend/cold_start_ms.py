"""Mean over the window's episodes of the time from an episode's start to
the end of its first step in which every lane converged (to the episode's
end where none did): what each new run or sweep costs before it answers."""


def read(w):
    eps = w["recorder"].episodes
    return 1e3 * sum((e.first_converged_end or e.end) - e.start
                     for e in eps) / len(eps)
