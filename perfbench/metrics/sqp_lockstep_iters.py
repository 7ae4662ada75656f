"""K1 launches per solve batch over the whole window, from the wrapper's
launch counter: on the sweep paths one launch is one lock-step SQP
iteration of the batch."""


def read(record):
    if record.kind != "sweep" or not record.k1_launches:
        return None
    return record.k1_launches / record.units
