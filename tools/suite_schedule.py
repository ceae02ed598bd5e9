#!/usr/bin/env python3
"""Per-file seconds of a test run, and its ``--dist loadfile`` schedule
replayed, from the run's junit XML:

  python3 tools/suite_schedule.py RUN.xml [--workers 6] [--top 20]

Prints the files by their summed test seconds, then the makespan of
pytest-xdist's ``loadfile`` scheduling replayed on those seconds: files in
collection (path) order, reordered by their number of tests, most first
(xdist's default ``--loadscope-reorder``); each worker takes one file, then
another whenever two or fewer of its tests are left. Setup outside the
tests (startup, collection) is not in the XML, so a real run takes longer
than the replay (the driver's run of a tree whose replay reads 1246 s took
1301 s).
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_times(path: str) -> dict:
    """{test file: [each test's seconds, in the XML's order]}."""
    files = collections.OrderedDict()
    for case in ET.parse(path).iter('testcase'):
        name = case.get('classname').replace('.', '/') + '.py'
        files.setdefault(name, []).append(float(case.get('time', 0)))
    return files


def replay(files: dict, workers: int) -> list:
    """Each worker's finishing second under ``loadfile`` scheduling."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]

    def hand_out(w):
        if queue:
            pending[w].extend(files[queue.popleft()])

    for w in range(workers):
        hand_out(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            hand_out(w)
    finish = [0.0] * workers
    clock = [(0.0, w) for w in range(workers)]
    while clock:
        t, w = heapq.heappop(clock)
        if not pending[w]:
            finish[w] = t
            continue
        t += pending[w].popleft()
        if len(pending[w]) <= 2:
            hand_out(w)
        heapq.heappush(clock, (t, w))
    return finish


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('xml')
    parser.add_argument('--workers', type=int, default=6)
    parser.add_argument('--top', type=int, default=20)
    args = parser.parse_args()
    files = file_times(args.xml)
    for name, times in sorted(files.items(), key=lambda kv: -sum(kv[1]))[
            :args.top]:
        print(f'{sum(times):8.1f} s {len(times):4d} tests  {name}')
    finish = replay(files, args.workers)
    print(f'{sum(map(sum, files.values())):.1f} s of tests in '
          f'{len(files)} files; loadfile over {args.workers} workers: '
          f'{max(finish):.1f} s (workers done at '
          + ', '.join(f'{t:.0f}' for t in sorted(finish)) + ')')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
