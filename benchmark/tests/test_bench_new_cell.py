"""A cell is added from new files alone.  In a copy of ``BENCHMARK.json`` and
``benchmark/``, two cells are added under new names, each an existing
configuration and traffic: the first with its small sizes and its check
file, the second with its check file only.  The harness's tests of the
first pass in a subprocess, the second fails one named test, and no file
of the copy that was there before is changed."""
import hashlib
import json
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BASE = 'si100k.kpath_calculate'
NEW, BARE = BASE + '_twin', BASE + '_bare'


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob('*') if p.is_file() and '__pycache__' not in p.parts}


def outcomes(xml: Path) -> dict:
    """{test id: 'passed', 'failure', 'error' or 'skipped'} of a junit file."""
    out = {}
    for case in ET.parse(xml).iter('testcase'):
        kinds = [c.tag for c in case if c.tag in ('failure', 'error', 'skipped')]
        out[case.get('name')] = kinds[0] if kinds else 'passed'
    return out


def test_a_cell_is_added_from_new_files_alone(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (tmp_path / 'psa_tpu_torch').symlink_to(ROOT / 'psa_tpu_torch')
    bench = tmp_path / 'benchmark'
    before = digests(bench)

    spec = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    base = next(w for w in spec['workloads'] if w['name'] == BASE)
    rate = next(m for m in spec['end_to_end'] if m['name'] == 'kpoints_per_s')
    for name in (NEW, BARE):
        spec['workloads'].append(dict(base, name=name))
        rate['workloads'].append(name)
        shutil.copy(bench / 'checks' / f'{BASE}.json', bench / 'checks' / f'{name}.json')
    shutil.copy(bench / 'tests' / 'tiny' / f'{BASE}.json', bench / 'tests' / 'tiny' / f'{NEW}.json')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec, indent=2))

    xml = tmp_path / 'tests.xml'
    run = subprocess.run([sys.executable, '-m', 'pytest', 'benchmark/tests', '-q',
                          '-p', 'no:cacheprovider', '-m', 'not chip', '-k', f'{NEW} or {BARE}',
                          f'--junitxml={xml}'], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    got = outcomes(xml)
    new = {t: o for t, o in got.items() if t.endswith(f'{NEW}]')}
    bare = {t: o for t, o in got.items() if t.endswith(f'{BARE}]')}
    checks = {f'test_the_port_agrees_with_the_reference[{NEW}]',
              f'test_the_control_is_not_correct[{NEW}]',
              f'test_every_file_is_found_by_name[{NEW}]',
              f'test_every_cell_has_its_small_sizes[{NEW}]'} | {
        f'test_a_broken_timed_path_is_not_correct[{fault}-{NEW}]'
        for fault in ('unchanged_state', 'half_batch', 'altered_answer')}
    assert checks <= set(new) and set(new.values()) == {'passed'}, (new, run.stdout[-3000:])
    failed = {t for t, o in bare.items() if o != 'passed' and o != 'skipped'}
    assert failed == {f'test_every_cell_has_its_small_sizes[{BARE}]'}, (bare, run.stdout[-3000:])
    assert bare[f'test_every_file_is_found_by_name[{BARE}]'] == 'passed'
    assert run.returncode == 1 and set(got) == set(new) | set(bare)

    after = digests(bench)
    assert {f: d for f, d in after.items() if f in before} == before
