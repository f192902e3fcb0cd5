"""Segment audio seconds of every fine-tuning iteration of the window
(batch x segment / sampling rate each), over the window's seconds."""


def read(record):
    if record.get('kind') != 'gan':
        return None
    return record['audio_s'] / record['window_s']
