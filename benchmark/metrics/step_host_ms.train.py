"""Host ms a step inside train.step.train_step (forward, backward,
clipping, Adam): the time to issue its work, with whatever waits for the
device it makes."""


def read(window):
    spans = [b - a for name, a, b in window["spans"] if name == "train_step"]
    return sum(spans) * 1e3 / len(spans) if spans else None
