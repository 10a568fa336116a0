"""The port's attention signal against the JAX package's (f32, CPU).

Aggregation (the numpy copy bitwise, the torch one within rtol 1e-5) on the
batch of tests/test_signal.py; the answer bonus; ``make_generate_and_score_fn``
on the engine route and the layer-unrolled route (tokens equal, scores within
tests/test_signal.py's bounds); the Porter stemmer against NLTK's word for
word, and the stem and include metrics against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lako_tpu.core.config import AttentionSignalConfig as JaxSignalConfig
from lako_tpu.core.config import ReaderDataConfig as JaxDataConfig
from lako_tpu.core.config import T5Config as JaxT5Config
from lako_tpu.data import ReaderCollator as JaxCollator
from lako_tpu.data import ReaderDataset as JaxDataset
from lako_tpu.models.t5.decode import make_generate_and_score_fn as jax_generate_and_score
from lako_tpu.models.t5.model import FiDT5 as JaxFiDT5
from lako_tpu.signal import aggregate as jax_aggregate
from lako_tpu.text import metrics as jax_metrics
from lako_tpu_torch.core.config import AttentionSignalConfig, T5Config
from lako_tpu_torch.models.t5 import FiDT5, params_from_jax
from lako_tpu_torch.models.t5.convert import init_fid_t5
from lako_tpu_torch.models.t5.decode import make_generate_and_score_fn
from lako_tpu_torch.signal import aggregate
from lako_tpu_torch.text import metrics
from lako_tpu_torch.text.stem import porter_stem, stem_set, word_tokenize
from tests.fixtures import corpus_sentences, make_examples, make_tokenizer

STYLES = ["mean", "max", "21mean"]

# Common English words and the forms each Porter step rewrites (plurals,
# -ed/-ing, -y, the step-2/3/4 suffixes, doubled consonants, NLTK's
# irregular forms).
WORDS = """
a able about above accept according account across act action activity actually
add address administration admit adult affect after again against age agency agent
ago agree agreement ahead air all allow almost alone along already also although
always american among amount analysis and animal another answer any anyone anything
appear apply approach area argue arm around arrive art article artist as ask assume
at attack attention attorney audience author authority available avoid away baby
back bad bag ball bank bar base be beat beautiful because become bed before begin
behavior behind believe benefit best better between beyond big bill billion bit
black blood blue board body book born both box boy break bring brother budget build
building business but buy by call camera campaign can cancer candidate capital car
card care career carry case catch cause cell center central century certain
certainly chair challenge chance change character charge check child choice choose
church citizen city civil claim class clear clearly close coach cold collection
college color come commercial common community company compare computer concern
condition conference congress consider consumer contain continue control cost could
country couple course court cover create crime cultural culture cup current
customer cut dark data daughter day dead deal death debate decade decide decision
deep defense degree democrat democratic describe design despite detail determine
develop development die difference different difficult dinner direction director
discover discuss discussion disease do doctor dog door down draw dream drive drop
drug during each early east easy eat economic economy edge education effect effort
eight either election else employee end energy enjoy enough enter entire
environment environmental especially establish even evening event ever every
everybody everyone everything evidence exactly example executive exist expect
experience expert explain eye face fact factor fail fall family far fast father
fear federal feel feeling few field fight figure fill film final finally financial
find fine finger finish fire firm first fish five floor fly focus follow food foot
for force foreign forget form former forward four free friend from front full fund
future game garden gas general generation get girl give glass go goal good
government great green ground group grow growth guess gun guy hair half hand hang
happen happy hard have he head health hear heart heat heavy help her here herself
high him himself his history hit hold home hope hospital hot hotel hour house how
however huge human hundred husband idea identify if image imagine impact important
improve in include including increase indeed indicate individual industry
information inside instead institution interest interesting international
interview into investment involve issue it item its itself job join just keep key
kid kill kind kitchen know knowledge land language large last late later laugh law
lawyer lay lead leader learn least leave left leg legal less let letter level lie
life light like likely line list listen little live local long look lose loss lot
love low machine magazine main maintain major majority make man manage management
manager many market marriage material matter may maybe me mean measure media
medical meet meeting member memory mention message method middle might military
million mind minute miss mission model modern moment money month more morning most
mother mouth move movement movie much music must my myself name nation national
natural nature near nearly necessary need network never new news newspaper next
nice night none nor north not note nothing notice now number occur of off offer
office officer official often oh oil ok old on once one only onto open operation
opportunity option or order organization other others our out outside over own
owner page pain painting paper parent part participant particular particularly
partner party pass past patient pattern pay peace people per perform performance
perhaps period person personal phone physical pick picture piece place plan plant
play player point police policy political politics poor popular population position
positive possible power practice prepare present president pressure pretty prevent
price private probably problem process produce product production professional
professor program project property protect prove provide public pull purpose push
put quality question quickly quite race radio raise range rate rather reach read
ready real reality realize really reason receive recent recently recognize record
red reduce reflect region relate relationship religious remain remember remove
report represent republican require research resource respond response
responsibility rest result return reveal rich right rise risk road rock role room
rule run safe same save say scene school science scientist score sea season seat
second section security see seek seem sell send senior sense series serious serve
service set seven several shake share she shoot short shot should shoulder show
side sign significant similar simple simply since sing single sister sit site
situation six size skill skin small smile so social society soldier some somebody
someone something sometimes son song soon sort sound source south southern space
speak special specific speech spend sport spring staff stage stand standard star
start state statement station stay step still stock stop store story strategy
street strong structure student study stuff style subject success successful such
suddenly suffer suggest summer support sure surface system table take talk task tax
teach teacher team technology television tell ten tend term test than thank that
the their them themselves then theory there these they thing think third this those
though thought thousand threat three through throughout throw thus time to today
together tonight too top total tough toward town trade traditional training travel
treat treatment tree trial trip trouble true truth try turn tv two type under
understand unit until up upon us use usually value various very victim view
violence visit voice vote wait walk wall want war watch water way we weapon wear
week weight well west western what whatever when where whether which while white
who whole whom whose why wide wife will win wind window wish with within without
woman wonder word work worker world worry would write writer wrong yard yeah year
yes yet you young your yourself
caresses ponies ties caress cats feed agreed plastered bled motoring sing conflated
troubled sized hopping tanned falling hissing fizzed failing filing happy sky skies
relational conditional rational valenci hesitanci digitizer conformabli radicalli
differentli vileli analogousli vietnamization predication operator feudalism
decisiveness hopefulness callousness formaliti sensitiviti sensibiliti triplicate
formative formalize electriciti electrical hopeful goodness revival allowance
inference airliner gyroscopic adjustable defensible irritant replacement adjustment
dependent adoption homologou communism activate angulariti homologous effective
bowdlerize probate cease controll roll generously dying lying tying innings outings
cannings howe proceed exceed succeed generalizations oscillators running jumped
quickly spied flies tried cried enjoyment analogy biology fully carefully
beautifully apologies emptied studies studying stories meetings lied died ties
""".split()


def _jax_cfg(style, last_half, n_context=3):
    return JaxSignalConfig(attention_score_style=style, use_last_half_layer_attention=last_half,
                           n_context=n_context)


def _port_cfg(style, last_half, n_context=3):
    return AttentionSignalConfig(attention_score_style=style,
                                 use_last_half_layer_attention=last_half, n_context=n_context)


@pytest.fixture(scope="module")
def batch_and_logits():
    """tests/test_signal.py's batch: six fixture examples, three facts."""
    tok = make_tokenizer()
    cfg = JaxDataConfig(n_context=3, text_maxlength=24, answer_maxlength=4, stream=2)
    ds = JaxDataset(make_examples(6, n_facts=3, seed=5), cfg)
    batch = JaxCollator(cfg, tok)([ds[i] for i in range(6)])
    B, N, L = batch.passage_ids.shape
    logits = np.random.default_rng(0).normal(size=(B, 4, 2, N * L)).astype(np.float32)
    return batch, logits


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("last_half", [False, True])
def test_aggregation_matches_jax(batch_and_logits, style, last_half):
    """The numpy copy bitwise; the torch version within rtol 1e-5 of the
    JAX device version and of the numpy one; the question-passage score
    bitwise."""
    batch, logits = batch_and_logits
    want = jax_aggregate.aggregate_fact_scores(logits, batch.passage_mask, batch.fact_spans,
                                               _jax_cfg(style, last_half))
    got = aggregate.aggregate_fact_scores(logits, batch.passage_mask, batch.fact_spans,
                                          _port_cfg(style, last_half))
    np.testing.assert_array_equal(got, want)
    jdev = np.asarray(jax_aggregate.aggregate_fact_scores_device(
        jnp.asarray(logits), jnp.asarray(batch.passage_mask), jnp.asarray(batch.fact_spans),
        _jax_cfg(style, last_half)))
    dev = aggregate.aggregate_fact_scores_device(
        torch.from_numpy(logits), torch.from_numpy(batch.passage_mask),
        torch.from_numpy(batch.fact_spans), _port_cfg(style, last_half))
    assert dev.dtype == torch.float32 and dev.shape == (6, 3)
    np.testing.assert_allclose(dev.numpy(), jdev, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dev.numpy(), want, rtol=1e-5, atol=1e-6)
    spans = np.stack([np.full(6, 2), np.arange(6) + 3], axis=1).astype(np.int32)
    np.testing.assert_array_equal(
        aggregate.question_passage_score(logits, batch.passage_mask, spans,
                                         _port_cfg(style, last_half)),
        jax_aggregate.question_passage_score(logits, batch.passage_mask, spans,
                                             _jax_cfg(style, last_half)))


@pytest.mark.parametrize("style", STYLES)
def test_device_aggregation_pads_missing_facts(style):
    """A missing fact gets −5, divided by the post-chunk layers × heads too,
    as in the JAX package; 21mean takes (e − s + 1) // 2 values."""
    B, layers, heads, N, L = 1, 5, 2, 2, 10
    logits = np.random.default_rng(1).normal(size=(B, layers, heads, N * L)).astype(np.float32)
    mask = np.ones((B, N, L), dtype=bool)
    mask[0, 1, 8:] = False
    spans = np.zeros((B, 4, 2), dtype=np.int32)
    spans[0, 0], spans[0, 1] = (2, 5), (5, 10)       # the second span runs into masked keys
    for last_half in (False, True):
        got = aggregate.aggregate_fact_scores_device(
            torch.from_numpy(logits), torch.from_numpy(mask), torch.from_numpy(spans),
            _port_cfg(style, last_half, n_context=4)).numpy()
        want = np.asarray(jax_aggregate.aggregate_fact_scores_device(
            jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(spans),
            _jax_cfg(style, last_half, n_context=4)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        used_layers = layers - layers // 2 if last_half else layers
        np.testing.assert_allclose(got[0, 2:], -5.0 / (used_layers * heads), rtol=1e-6)


@pytest.mark.parametrize("ans_attention", [False, True])
def test_ans_attention_bonus_matches_jax(ans_attention):
    examples = make_examples(5, n_facts=4, seed=3)
    examples[1]["fact"] = examples[1]["fact"][:2]        # fewer facts than n_context
    examples[2]["answer"] = {"howls": 0.6, "a meow": 1.0}
    scores = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
    got = aggregate.apply_ans_attention_bonus(scores, examples, 4, ans_attention)
    want = jax_aggregate.apply_ans_attention_bonus(scores, examples, 4, ans_attention)
    np.testing.assert_array_equal(got, want)
    a, b = make_examples(2, n_facts=3), make_examples(2, n_facts=3)
    aggregate.attach_scores_to_examples(a, got, 3)
    jax_aggregate.attach_scores_to_examples(b, want, 3)
    assert a == b


@pytest.fixture(scope="module")
def scoring_model():
    """A tiny T5 at the fixture tokenizer's vocabulary and a collated batch
    of four examples with three facts, from one flax init."""
    tok = make_tokenizer()
    dcfg = JaxDataConfig(n_context=3, text_maxlength=24, answer_maxlength=4, stream=2)
    ds = JaxDataset(make_examples(4, 3, 11), dcfg)
    batch = JaxCollator(dcfg, tok)([ds[i] for i in range(4)])
    kw = dict(vocab_size=tok.vocab_size, d_model=32, d_kv=8, d_ff=64, num_layers=2,
              num_decoder_layers=2, num_heads=2, relative_attention_num_buckets=8,
              dropout_rate=0.0)
    jm = JaxFiDT5(JaxT5Config(**kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch.passage_ids),
                     jnp.asarray(batch.passage_mask), jnp.zeros((4, 4), jnp.int32))["params"]
    model = FiDT5(T5Config(**kw))
    model.load_state_dict(params_from_jax(params))
    return jm, params, model.eval(), batch


@pytest.mark.parametrize("backend", ["auto", "flax"])
@pytest.mark.parametrize("style,last_half", [("mean", False), ("21mean", True)])
def test_generate_and_score_matches_jax(scoring_model, backend, style, last_half):
    """The engine route ("auto") and the layer-unrolled route ("flax"):
    tokens equal to the JAX function's, scores within rtol 1e-4 / atol 1e-5."""
    jm, params, model, batch = scoring_model
    arrays = (batch.passage_ids, batch.passage_mask, batch.fact_spans)
    jtok, jscores = jax_generate_and_score(jm, _jax_cfg(style, last_half), max_length=4,
                                           backend=backend)(params, *map(jnp.asarray, arrays))
    fn = make_generate_and_score_fn(model, _port_cfg(style, last_half), max_length=4,
                                    backend=backend)
    tokens, scores = fn(*map(torch.from_numpy, arrays))
    assert scores.shape == (4, 3) and scores.dtype == torch.float32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-5)


def test_generate_and_score_raises_where_jax_raises(scoring_model):
    """backend="engine" on a FiDO decoder raises in the JAX package; the
    port's greedy engine runs FiDO, so there it scores as the layer-unrolled
    route does (tests/test_torch_fido.py holds the scores to each other)."""
    kw = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=4,
              num_heads=4, cross_attention_stride=2)
    with pytest.raises(ValueError, match="engine"):
        jax_generate_and_score(JaxFiDT5(JaxT5Config(**kw)), JaxSignalConfig(), backend="engine")
    batch = scoring_model[3]
    fido = init_fid_t5(T5Config(**dict(kw, vocab_size=scoring_model[2].config.vocab_size)),
                       torch.Generator().manual_seed(0))
    arrays = [torch.from_numpy(a) for a in (batch.passage_ids, batch.passage_mask,
                                            batch.fact_spans)]
    tokens, scores = make_generate_and_score_fn(fido, AttentionSignalConfig(), max_length=4,
                                                backend="engine")(*arrays)
    want_tokens, want_scores = make_generate_and_score_fn(
        fido, AttentionSignalConfig(), max_length=4, backend="flax")(*arrays)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens.numpy())
    np.testing.assert_allclose(scores.numpy(), want_scores.numpy(), rtol=1e-4, atol=1e-5)


def _fixture_words():
    text = " ".join(corpus_sentences() + [f"{e['question']} {e['caption']}"
                                          for e in make_examples(20, n_facts=3)])
    return sorted(set(word_tokenize(text.lower())))


def test_porter_stem_matches_nltk():
    """NLTK's PorterStemmer in its default mode, on every word of the fixture
    corpus and the word list (irregular forms and each step's suffixes)."""
    nltk_porter = pytest.importorskip("nltk.stem.porter")
    stemmer = nltk_porter.PorterStemmer()
    words = sorted(set(WORDS) | set(_fixture_words()))
    assert len(set(WORDS)) >= 500
    wrong = {w: (porter_stem(w), stemmer.stem(w)) for w in words
             if porter_stem(w) != stemmer.stem(w)}
    assert not wrong
    assert [porter_stem(w) for w in ("dying", "generously", "sky", "Skies")] == \
        ["die", "gener", "sky", "sky"]


def test_tokenize_and_stem_metrics_match_jax():
    from lako_tpu.text import stem as jax_stem

    text = "The dog's owner said: well-known cats -- 3.5 hours, don't they?"
    assert word_tokenize(text) == jax_stem.word_tokenize(text)
    assert stem_set(text) == jax_stem.stem_set(text)
    golds = [{"meow": 1.0}, {"running dogs": 0.6, "ran": 1.0}, {"the hoot": 0.3}]
    preds = ["meowing", "a dog runs", "hooting owls", "the", "", "cats says meow."]
    for pred in preds:
        for gold in golds:
            assert metrics.includ_ems(pred, gold) == jax_metrics.includ_ems(pred, gold)
            for dele_sw in (False, True):
                assert metrics.stem_ems(pred, gold, dele_sw) == \
                    jax_metrics.stem_ems(pred, gold, dele_sw), (pred, gold, dele_sw)
