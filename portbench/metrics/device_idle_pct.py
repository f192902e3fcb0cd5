"""The share of the traced stretch's wall time in which no device
activity (kernel, copy, set) ran: 100 - union of device time. One reader
for every ``device_idle_pct.<kind>`` metric: each kind's cells list the
metric of their own end-to-end metric."""


def read(record):
    tr = record.get('trace')
    if not tr or not tr['window_s']:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
