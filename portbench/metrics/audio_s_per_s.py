"""Real audio seconds delivered over the whole window, over its seconds
(each utterance's own frames x hop / sampling rate; padding not
counted)."""


def read(record):
    if record.get('kind') != 'synth':
        return None
    return sum(it['audio_s'] for it in record['items']) / record['window_s']
