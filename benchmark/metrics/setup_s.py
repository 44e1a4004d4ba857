"""Set-up: process start to the first timed step (scene, weights, model,
loader, kernel builds, the checked and warm-up steps)."""


def read(window):
    return window["setup_s"]
