"""Mean host time per batch of the window in the vocoder's call
(``HiFiGanVocoder.infer``, which ends in a copy to the host): the
benchmark's span around the call."""


def read(record):
    if record.get('kind') != 'synth':
        return None
    items = record['items']
    return sum(it['t2'] - it['t1'] for it in items) / len(items) * 1e3
