"""Synthetic join datasets + the simulated Alg-2 LLM backends.

Generators mirror the paper's six real datasets structurally (§8.2's three
categories) and the §8.4 templated-sentence generator (entity-count and
text-length sweeps).  Ground truth is known by construction; each dataset
carries a *schema* of latent fields with per-field extraction difficulty so
the simulated proposer/extractor reproduce the paper's LLM behaviors:
redundant or erroneous featurizations first, fixed when the Alg-1 feedback
loop surfaces failing examples.

Determinism: every record's corruption is keyed by (spec, side, index) via a
stable hash — repeated extraction of the same record yields the same value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.llm import SimulatedOracle, _stable_hash


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    distance_kind: str            # semantic | word_overlap | arithmetic | date
    llm_needed: bool = True       # should-use-llm verdict
    relevance: float = 1.0        # proposer ordering signal
    base_noise: float = 0.0       # extraction corruption prob at version 0
    missing: float = 0.0          # extraction missing prob


@dataclasses.dataclass
class JoinDataset:
    name: str
    texts_l: list
    texts_r: list
    fields_l: dict                # field name -> list of true values (or None)
    fields_r: dict
    schema: list                  # list[Field]
    truth_set: set                # {(i, j)}
    join_prompt: str
    self_join: bool = False

    @property
    def n_l(self) -> int:
        return len(self.texts_l)

    @property
    def n_r(self) -> int:
        return len(self.texts_r)

    @property
    def n_positive(self) -> int:
        return len(self.truth_set)

    def truth(self, i: int, j: int) -> bool:
        return (i, j) in self.truth_set

    def make_oracle(self, latency_s: float = 0.0) -> SimulatedOracle:
        return SimulatedOracle(self.texts_l, self.texts_r, self.truth,
                               join_prompt=self.join_prompt + " {l} ||| {r}",
                               latency_s=latency_s)


# ---------------------------------------------------------------------------
# word pools (deterministic)
# ---------------------------------------------------------------------------

_SYL = ["ba", "ra", "mi", "ko", "ta", "li", "su", "ne", "vo", "da", "ше"[:0] or "ze",
        "fa", "lo", "ki", "ru", "ma", "te", "no", "vi", "sa"]
_ADJ = ["silent", "crimson", "lost", "golden", "broken", "hidden", "last",
        "burning", "frozen", "electric", "paper", "midnight", "hollow",
        "savage", "gentle", "distant"]
_NOUN = ["river", "empire", "garden", "horizon", "letter", "shadow", "engine",
         "harbor", "mirror", "station", "voyage", "canyon", "signal", "orchid",
         "archive", "monsoon"]
_STREET = ["Bay", "Adam", "Oak", "Hill", "Lake", "Main", "Pine", "Cedar",
           "River", "Sunset", "Market", "Union", "Grove", "Walnut"]
_CITY = ["Fairview", "Riverton", "Lakewood", "Brookside", "Hillcrest",
         "Maplewood", "Westfield", "Northgate"]
_BRAND = ["Voltron", "Acme", "Zenith", "Polarix", "Nimbus", "Vertex", "Orion",
          "Quasar"]
_COLOR = ["black", "white", "silver", "blue", "red", "green", "graphite"]
_CATEGORY = ["kitchen appliances", "outdoor gear", "office electronics",
             "garden tools", "pet supplies", "sports equipment",
             "home lighting", "audio devices", "car accessories",
             "baby products", "craft materials", "computer parts"]
_REACTION = ["nausea", "dizziness", "skin rash", "headache", "insomnia",
             "joint pain", "fatigue", "blurred vision", "dry mouth", "anxiety",
             "tremor", "fever", "palpitations", "loss of appetite"]
_FILLER = [
    "The committee will reconvene after the scheduled maintenance window",
    "Additional documentation is archived in the central records office",
    "Routine procedures were followed according to the published manual",
    "No further remarks were entered into the register at this time",
    "Subsequent amendments may be filed through the standard channels",
    "The undersigned affirms the accuracy of the foregoing statements",
    "Weather conditions on the day were unremarkable and mild",
    "Members of the public may request copies subject to applicable fees",
]


def _rng(seed, *key) -> np.random.Generator:
    h = _stable_hash("|".join(str(k) for k in key), seed=seed)
    return np.random.default_rng(h % (2**63))


def _person_name(rng) -> str:
    def w(n):
        return "".join(rng.choice(_SYL) for _ in range(n)).capitalize()
    return f"{w(2)} {w(3)}"


def _movie_name(rng) -> str:
    return f"The {rng.choice(_ADJ).capitalize()} {rng.choice(_NOUN).capitalize()}"


def _filler(rng, n_sentences: int) -> str:
    if n_sentences <= 0:
        return ""
    return " ".join(str(rng.choice(_FILLER)) + "." for _ in range(n_sentences))


# ---------------------------------------------------------------------------
# §8.4 generator — movie-likes sentences (Fig 10 sweeps) and Movies analogue
# ---------------------------------------------------------------------------

def movie_likes(n: int = 400, persons_per_sentence: int = 1,
                filler_sentences: int = 0, seed: int = 0) -> JoinDataset:
    """Self-join: do two records mention a movie liked by the same person?

    D construction per §8.4: n persons, n movies, each person -> 2 movies,
    each movie -> 2 persons => 2n rows.
    """
    rng = _rng(seed, "movie_likes", n)
    persons = [_person_name(rng) for _ in range(n)]
    movies = [_movie_name(rng) for _ in range(n)]
    rows = []
    for i in range(n):
        rows.append((i, i))                       # person i likes movie i
        rows.append((i, (i + 1) % n))             # person i likes movie i+1
    texts, f_person, f_movie = [], [], []
    for ridx, (p, m) in enumerate(rows):
        extra = [persons[(p + 7 * (j + 1)) % n]
                 for j in range(persons_per_sentence - 1)]
        names = [persons[p]] + extra
        if len(names) > 1:
            namestr = ", ".join(names[:-1]) + " and " + names[-1]
        else:
            namestr = names[0]
        rr = _rng(seed, "filler", ridx)
        t1, t2 = _filler(rr, filler_sentences), _filler(rr, filler_sentences)
        verb = "likes" if len(names) == 1 else "like"
        sent = (f"{t1} For example, {namestr} {verb} "
                f"the movie {movies[m]}. {t2}").strip()
        texts.append(sent)
        f_person.append(" ".join(names))
        f_movie.append(movies[m])
    truth = set()
    by_person: dict = {}
    for ridx, (p, m) in enumerate(rows):
        extra = [(p + 7 * (j + 1)) % n for j in range(persons_per_sentence - 1)]
        for pp in [p] + extra:
            by_person.setdefault(pp, []).append(ridx)
    for pp, rids in by_person.items():
        for a in rids:
            for b in rids:
                if a != b:
                    truth.add((a, b))
    schema = [
        Field("person_names", "word_overlap", llm_needed=True, relevance=1.0,
              base_noise=0.02),
        Field("movie_name", "word_overlap", llm_needed=True, relevance=0.3,
              base_noise=0.02),
    ]
    return JoinDataset(
        name=f"movie_likes_p{persons_per_sentence}_f{filler_sentences}",
        texts_l=texts, texts_r=texts,
        fields_l={"person_names": f_person, "movie_name": f_movie},
        fields_r={"person_names": f_person, "movie_name": f_movie},
        schema=schema, truth_set=truth, self_join=True,
        join_prompt="Do the two records mention a movie liked by the same person?")


def movies_pages(n_movies: int = 150, cast_size: int = 6, filler_sentences: int = 4,
                 seed: int = 0) -> JoinDataset:
    """Movies analogue (category 1): movie pages x actor pages, join = acts-in."""
    rng = _rng(seed, "movies_pages", n_movies)
    movies = [_movie_name(rng) for _ in range(n_movies)]
    n_actors = n_movies * 2
    actors = [_person_name(rng) for _ in range(n_actors)]
    cast = {m: sorted(rng.choice(n_actors, size=cast_size, replace=False).tolist())
            for m in range(n_movies)}
    texts_l, f_title, f_cast = [], [], []
    for m in range(n_movies):
        rr = _rng(seed, "mfill", m)
        names = ", ".join(actors[a] for a in cast[m])
        texts_l.append(
            f"{_filler(rr, filler_sentences)} {movies[m]} is a feature film. "
            f"The cast includes {names}. {_filler(rr, filler_sentences)}")
        f_title.append(movies[m])
        f_cast.append(" ".join(actors[a] for a in cast[m]))
    texts_r, f_actor, f_filmo = [], [], []
    films_of: dict = {a: [] for a in range(n_actors)}
    for m, cs in cast.items():
        for a in cs:
            films_of[a].append(m)
    for a in range(n_actors):
        rr = _rng(seed, "afill", a)
        filmo = ", ".join(movies[m] for m in films_of[a]) or "various stage plays"
        texts_r.append(
            f"{_filler(rr, filler_sentences)} {actors[a]} is an actor known "
            f"for {filmo}. {_filler(rr, filler_sentences)}")
        f_actor.append(actors[a])
        f_filmo.append(" ".join(movies[m] for m in films_of[a]))
    truth = {(m, a) for m, cs in cast.items() for a in cs}
    schema = [
        Field("cast_or_actor", "word_overlap", relevance=1.0, base_noise=0.03),
        Field("title_or_films", "word_overlap", relevance=0.9, base_noise=0.03),
    ]
    return JoinDataset(
        name="movies_pages", texts_l=texts_l, texts_r=texts_r,
        fields_l={"cast_or_actor": f_cast, "title_or_films": f_title},
        fields_r={"cast_or_actor": f_actor, "title_or_films": f_filmo},
        schema=schema, truth_set=truth,
        join_prompt="Is the person a cast or crew member of the movie?")


def citations(n_docs: int = 300, filler_sentences: int = 3, seed: int = 0) -> JoinDataset:
    """Citations analogue (category 1): one dominant feature (case number)."""
    rng = _rng(seed, "citations", n_docs)
    n_cases = max(n_docs // 3, 1)
    case_ids = [f"{rng.integers(1,5)}-CR-{rng.integers(1000, 9999)}" for _ in range(n_cases)]
    texts, f_case = [], []
    for i in range(n_docs):
        c = int(rng.integers(0, n_cases))
        rr = _rng(seed, "cfill", i)
        texts.append(
            f"{_filler(rr, filler_sentences)} The court relies on the holding "
            f"in case {case_ids[c]} as controlling precedent. "
            f"{_filler(rr, filler_sentences)}")
        f_case.append(case_ids[c])
    truth = {(i, j) for i in range(n_docs) for j in range(n_docs)
             if i != j and f_case[i] == f_case[j]}
    schema = [
        Field("case_number", "word_overlap", llm_needed=False, relevance=1.0,
              base_noise=0.01),
        Field("legal_topic", "semantic", relevance=0.2, base_noise=0.05),
    ]
    topics = [t.split()[0] for t in f_case]
    return JoinDataset(
        name="citations", texts_l=texts, texts_r=texts,
        fields_l={"case_number": f_case, "legal_topic": topics},
        fields_r={"case_number": f_case, "legal_topic": topics},
        schema=schema, truth_set=truth, self_join=True,
        join_prompt="Do the two legal arguments cite the same case?")


def police_records(n_incidents: int = 120, reports_per_incident: int = 2,
                   filler_sentences: int = 8, seed: int = 0) -> JoinDataset:
    """Police-records analogue (category 2, the running example): multiple
    weak features — date (±1 day jitter), location paraphrase, officer names."""
    rng = _rng(seed, "police", n_incidents)
    texts, f_date, f_loc, f_off, inc_of = [], [], [], [], []
    for inc in range(n_incidents):
        day0 = int(rng.integers(0, 3650))
        street = rng.choice(_STREET)
        cross = rng.choice([s for s in _STREET if s != street])
        city = rng.choice(_CITY)
        officers = [_person_name(rng) for _ in range(3)]
        for rep in range(reports_per_incident):
            rr = _rng(seed, "pfill", inc, rep)
            day = day0 + int(rr.integers(0, 2))          # ±1 day jitter
            loc_variants = [
                f"the intersection of {street} and {cross} St in {city}",
                f"{street} St at {cross}, {city}",
                f"near {cross} and {street} Streets, {city}",
            ]
            loc = loc_variants[int(rr.integers(0, len(loc_variants)))]
            offs = [officers[k] for k in rr.permutation(3)[: int(rr.integers(1, 4))]]
            texts.append(
                f"{_filler(rr, filler_sentences)} On day {day}, officers "
                f"{', '.join(offs)} responded to an incident at {loc}. "
                f"{_filler(rr, filler_sentences)}")
            f_date.append(float(day))
            f_loc.append(loc)
            f_off.append(" ".join(offs))
            inc_of.append(inc)
    n = len(texts)
    truth = {(i, j) for i in range(n) for j in range(n)
             if i != j and inc_of[i] == inc_of[j]}
    schema = [
        Field("incident_date", "arithmetic", llm_needed=True, relevance=1.0,
              base_noise=0.05, missing=0.02),
        Field("location", "semantic", llm_needed=True, relevance=0.9,
              base_noise=0.05, missing=0.02),
        Field("officer_names", "word_overlap", llm_needed=True, relevance=0.8,
              base_noise=0.05, missing=0.02),
    ]
    return JoinDataset(
        name="police_records", texts_l=texts, texts_r=texts,
        fields_l={"incident_date": f_date, "location": f_loc, "officer_names": f_off},
        fields_r={"incident_date": f_date, "location": f_loc, "officer_names": f_off},
        schema=schema, truth_set=truth, self_join=True,
        join_prompt="Do the two police reports refer to the same incident?")


def products(n_products: int = 200, seed: int = 0) -> JoinDataset:
    """Products analogue (category 2): model numbers missing/truncated."""
    rng = _rng(seed, "products", n_products)
    texts_l, texts_r, fl, fr = [], [], {"model": [], "brand": [], "color": []}, \
        {"model": [], "brand": [], "color": []}
    truth = set()
    for p in range(n_products):
        brand = str(rng.choice(_BRAND))
        color = str(rng.choice(_COLOR))
        model = f"{brand[:2].upper()}{rng.integers(100, 999)}-{rng.integers(10, 99)}"
        for side, (txts, ff) in enumerate([(texts_l, fl), (texts_r, fr)]):
            rr = _rng(seed, "prod", p, side)
            m = model
            if rr.random() < 0.25:
                m = model.split("-")[0]                  # truncated digits
            if rr.random() < 0.2:
                m = None                                 # not listed
            desc = (f"{brand} {color} unit"
                    + (f" model {m}" if m else "")
                    + f". {_filler(rr, 2)}")
            txts.append(desc)
            ff["model"].append(m)
            ff["brand"].append(brand)
            ff["color"].append(color)
        truth.add((p, p))
    schema = [
        Field("model", "word_overlap", llm_needed=False, relevance=1.0,
              base_noise=0.02, missing=0.0),
        Field("brand", "word_overlap", llm_needed=True, relevance=0.7,
              base_noise=0.03),
        Field("color", "word_overlap", llm_needed=True, relevance=0.4,
              base_noise=0.03),
    ]
    return JoinDataset(
        name="products", texts_l=texts_l, texts_r=texts_r,
        fields_l=fl, fields_r=fr, schema=schema, truth_set=truth,
        join_prompt="Do the two listings describe the same product?")


def _category_pool(n: int) -> list:
    """Expand the base category list into n distinct labels (the real
    Categorize/BioDEX label spaces have 10^2-10^4 entries)."""
    out = []
    i = 0
    while len(out) < n:
        base = _CATEGORY[i % len(_CATEGORY)]
        adj = _ADJ[(i // len(_CATEGORY)) % len(_ADJ)]
        out.append(f"{adj} {base}" if i >= len(_CATEGORY) else base)
        i += 1
    return out


def categorize(n_items: int = 400, n_categories: int = 120, seed: int = 0) -> JoinDataset:
    """Categorize analogue (category 3): multi-label classification-as-join."""
    rng = _rng(seed, "categorize", n_items)
    cats = _category_pool(n_categories)
    texts_l, f_kw = [], []
    truth = set()
    for i in range(n_items):
        rr = _rng(seed, "cat", i)
        labels = [int(rr.integers(0, len(cats)))]
        if rr.random() < 0.1:                             # multi-label
            labels.append(int(rr.integers(0, len(cats))))
        hints = []
        for c in labels:
            truth.add((i, c))
            hints.append(" ".join(cats[c].split()[-2:]) if rr.random() < 0.93
                         else str(rng.choice(_NOUN)))
        texts_l.append(
            f"A {rng.choice(_COLOR)} {rng.choice(_ADJ)} item related to "
            f"{' and '.join(hints)} for daily use. {_filler(rr, 3)}")
        f_kw.append("; ".join(hints))
    schema = [
        Field("product_keywords", "semantic", relevance=1.0, base_noise=0.05),
        Field("category_name", "semantic", relevance=0.8, base_noise=0.0),
    ]
    return JoinDataset(
        name="categorize", texts_l=texts_l, texts_r=list(cats),
        fields_l={"product_keywords": f_kw, "category_name": f_kw},
        fields_r={"product_keywords": cats, "category_name": cats},
        schema=schema, truth_set=truth,
        join_prompt="Can the product be classified with the category?")


_BODY = ["arm", "knee", "chest", "back", "neck", "shoulder", "hip", "wrist",
         "ankle", "jaw"]
_SYMPTOM_SYNONYM = {
    "nausea": "felt queasy", "dizziness": "light-headedness",
    "skin rash": "red patches", "headache": "pressure in the head",
    "insomnia": "trouble sleeping", "joint pain": "aching joints",
    "fatigue": "persistent exhaustion", "blurred vision": "vision trouble",
    "dry mouth": "parched mouth", "anxiety": "feeling on edge",
    "tremor": "shaking hands", "fever": "elevated temperature",
    "palpitations": "racing heart", "loss of appetite": "no desire to eat",
}


def _reaction_pool(n: int) -> list:
    out = list(_REACTION)
    i = 0
    while len(out) < n:
        out.append(f"{_REACTION[i % len(_REACTION)]} of the "
                   f"{_BODY[(i // len(_REACTION)) % len(_BODY)]}")
        i += 1
    return out[:n]


def biodex(n_notes: int = 300, n_terms: int = 140, seed: int = 0) -> JoinDataset:
    """BioDEX analogue (category 3): weakly decomposable classification."""
    terms = _reaction_pool(n_terms)
    texts_l, f_sym = [], []
    truth = set()
    for i in range(n_notes):
        rr = _rng(seed, "bio", i)
        k = int(rr.integers(1, 3))
        cs = rr.choice(len(terms), size=k, replace=False)
        mentions = []
        for c in cs:
            truth.add((i, int(c)))
            base = terms[c].split(" of the ")[0]
            loc = terms[c][len(base):]
            m = _SYMPTOM_SYNONYM.get(base, base) if rr.random() < 0.55 else base
            mentions.append(m + loc)
        texts_l.append(
            f"Patient reports {', and '.join(mentions)} after starting the "
            f"medication. {_filler(rr, 4)}")
        f_sym.append("; ".join(mentions))
    schema = [
        Field("symptoms", "semantic", relevance=1.0, base_noise=0.06,
              missing=0.05),
        Field("term", "semantic", relevance=0.8, base_noise=0.0),
    ]
    return JoinDataset(
        name="biodex", texts_l=texts_l, texts_r=list(terms),
        fields_l={"symptoms": f_sym, "term": f_sym},
        fields_r={"symptoms": list(terms), "term": list(terms)},
        schema=schema, truth_set=truth,
        join_prompt="Does the medical reaction term apply to the patient?")


DATASETS: dict = {
    "citations": citations,
    "police_records": police_records,
    "categorize": categorize,
    "biodex": biodex,
    "movies": movies_pages,
    "products": products,
}
