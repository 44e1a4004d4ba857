"""Rays of every step completed in the window over the window's wall
time, which ends when the device has finished the last step."""


def read(window):
    return window["rays"] / window["seconds"]
